"""Item-sharded full-catalog scoring and the global top-K merge.

The counterpart of ``one_class_ffm_tpu/evalx/sharded_topk.py`` on a data
mesh of ``torch.distributed`` ranks (``parallel.mesh``).  The catalog axis
is sharded: each rank holds a contiguous slice of the items (its rows of
the item caches ``Q`` and sums ``bt``), scores it for the same user chunk,
takes a local top-K, and the global top-K is the top-K of the all-gathered
candidates: a payload of K per rank per user instead of the catalog.

Ties resolve to the lowest global item id, as the reference's first-max
destructive argmax does (ffm.cpp:1033-1037): the local top-K is the port's
tie-exact ``predict.rank_topk`` (a stable descending sort: lower local
index first), the gather concatenates the ranks' candidates in rank order
(= global id order), and the merge is another stable descending sort.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

Tensor = torch.Tensor


def _merge(mesh, vals: Tensor, gids: Tensor, k: int,
           site: str) -> Tuple[Tensor, Tensor]:
    """The global top ``k`` of every rank's (vals, global ids) candidates:
    all-gathered in rank order, then a stable descending sort."""
    from ..predict import rank_topk

    all_vals = mesh.all_gather(vals, site, dim=1)
    all_ids = mesh.all_gather(gids, site, dim=1)
    fvals, pos = rank_topk(all_vals, k)
    return fvals, all_ids.gather(1, pos)


def sharded_topk(z_parts_fn: Callable[..., Tensor], mesh, k: int,
                 axis: str = "data"):
    """A function of each rank's local inputs: its scores ``z_parts_fn(
    *local_inputs) -> (chunk, n_local)`` over its item slice (rank ``r``
    holds items ``[r * n_local, (r + 1) * n_local)``), a local top-K and
    the merge; returns the global (vals, ids), (chunk, k), the same on
    every rank."""
    from ..predict import rank_topk

    def impl(*local_inputs):
        z_local = z_parts_fn(*local_inputs)
        n_local = z_local.shape[1]
        vals, idx = rank_topk(z_local, min(k, n_local))
        return _merge(mesh, vals, idx + mesh.rank * n_local, k, "topk")

    return impl


def make_sharded_topk_fn(f12s: Sequence[int], mesh, k: int,
                         axis: str = "data", catalog: int = 0):
    """The serving / predict form over an item-sharded catalog.  Returns
    ``fn(Pva_c, cold_c, Q, bt, popular) -> (vals, ids)``, where ``Q``,
    ``bt`` and ``popular`` are this rank's rows of the item side (the
    item-sharded state's): z = bt + sum_c Pva_c Q_c^T over its items, cold
    users replaced by the popularity prior, items >= ``catalog`` masked out
    (0 = no mask), then the local top-K and the merge (ties to the lowest
    global id)."""
    f12s = sorted(f12s)
    from ..predict import rank_topk

    def fn(Pva_c: Dict[int, Tensor], cold_c: Tensor, Q: Dict[int, Tensor],
           bt: Tensor, popular: Tensor):
        chunk = cold_c.shape[0]
        n_local = bt.shape[0]
        z = bt[None, :].expand(chunk, n_local)
        for f12 in f12s:
            z = z + Pva_c[f12] @ Q[f12].T
        z = torch.where(cold_c[:, None], popular[None, :], z)
        gid = mesh.rank * n_local + torch.arange(n_local, device=z.device)
        if catalog:
            neg = torch.finfo(z.dtype).min
            z = torch.where((gid < catalog)[None, :], z,
                            torch.full_like(z, neg))
        vals, idx = rank_topk(z, min(k, n_local))
        return _merge(mesh, vals, gid[idx], k, "topk")

    return fn


def topk_over_sharded_catalog(Pva_c: Dict[int, Tensor],
                              Q: Dict[int, Tensor], bt: Tensor,
                              cross_blocks, mesh, k: int,
                              axis: str = "data") -> Tuple[Tensor, Tensor]:
    """One-shot global top-K of a user chunk (on every rank) against this
    rank's item rows ``Q`` / ``bt`` (no cold users, no catalog mask: see
    ``make_sharded_topk_fn`` for the serving path)."""
    chunk = next(iter(Pva_c.values())).shape[0]
    cold = torch.zeros(chunk, dtype=torch.bool, device=bt.device)
    pop = torch.zeros_like(bt)
    fn = make_sharded_topk_fn(sorted(Q), mesh, k, axis)
    return fn(Pva_c, cold, Q, bt, pop)
