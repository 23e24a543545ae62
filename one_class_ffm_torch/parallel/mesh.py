"""The 1-D ``data`` mesh of a multi-process run, on ``torch.distributed``.

The counterpart of ``one_class_ffm_tpu/parallel/mesh.py``.  There the same
jitted epoch runs on one device or many, and GSPMD inserts the collectives:
sharding is pure data placement.  PyTorch has no GSPMD, so here the solver
is explicit.  A ``Mesh`` is one process group of ``size`` ranks, one
process each; rank ``r`` holds:

  * its slice of the rows (users m, items n, each ``rows / size`` long and
    contiguous), of the shard-aligned positive stream (``pad_labels
    shard_rows=``: every entry on its user's rank) and of both sides'
    blocked layouts (``blocked_bm`` divides the rows per rank, so blocks
    nest in ranks); the caches P/Q, the side sums a/b and the residual
    carries are row- or block-sliced the same way;
  * a full copy of the block tables W/H and the per-feature arrays (reg,
    colsq), as the JAX package replicates them.

Every rank runs the same CG on the replicated table-space variable; the
collectives sit where the JAX solver's are (``tests/test_sharding.py``
pins that budget in the compiled HLO): per half-solve one all-gather of the
other side's cache rows for the pre-gathered stream, the gradient's and the
k x k Grams' all-reduces, the carry's cross-order propagation; inside each
CG iteration exactly one all-reduce, of Hv's table-space output.

``shard_data`` / ``shard_state`` cut a rank's slice from the full host
arrays, which every rank builds the same way from the seed (as
``multihost.py`` describes).  The collective helpers count their calls and
bytes per call site and scope (``Mesh.census``): the tests and
chip_smoke read that census.

Only the 1-D ``data`` mesh runs here.  A 2-D ``data x model`` mesh (tables
row-sharded on ``model``), the head tier and the plain COO passes under a
mesh raise ``NotImplementedError`` naming ROADMAP A11b.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_device

A11B = "ROADMAP A11b"


@dataclass
class Census:
    """Calls and bytes of each collective, by (op, call site, scope): the
    scope is ``"cg"`` inside a CG loop, else ``"solve"``."""

    records: Dict[Tuple[str, str, str], list] = field(default_factory=dict)

    def add(self, op: str, site: str, scope: str, nbytes: int) -> None:
        rec = self.records.setdefault((op, site, scope), [0, 0])
        rec[0] += 1
        rec[1] += int(nbytes)

    def reset(self) -> None:
        self.records.clear()

    def rows(self):
        """[(op, site, scope, calls, bytes)], sorted."""
        return sorted((o, site, s, c, b)
                      for (o, site, s), (c, b) in self.records.items())


class Mesh:
    """A 1-D ``data`` mesh: ``size`` ranks of ``group`` (the default group
    when None), this process being rank ``rank`` on ``device``.  A mesh of
    size 1 needs no group: its collectives return their input."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 group=None, axis: str = "data"):
        self.size, self.rank = int(size), int(rank)
        self.device = torch.device(device)
        self.group = group
        self.axis = axis
        self.census = Census()
        self._scope = "solve"
        self._staged = False
        if self.size > 1:
            # gloo reduces on the host: a card's tensors are staged there
            # explicitly (the transport, not the backend, changes)
            self._staged = (dist.get_backend(group) == "gloo"
                            and self.device.type == "cuda")

    def rows(self, n: int) -> slice:
        """This rank's slice of ``n`` rows (``n`` divisible by the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide the {self.axis} axis "
                             f"of size {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    @contextlib.contextmanager
    def scope(self, name: str):
        """Record the collectives of the block under ``name``."""
        saved, self._scope = self._scope, name
        try:
            yield
        finally:
            self._scope = saved

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` at a float32 floor (float inputs), on
        the host when gloo stages a card's tensors."""
        dt = (torch.promote_types(t.dtype, torch.float32)
              if t.is_floating_point() else t.dtype)
        buf = t.to(dtype=dt, copy=True).contiguous()
        return buf.cpu() if self._staged else buf

    def all_reduce_sum(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks, at a float32 floor, returned at
        ``t``'s dtype on its device."""
        buf = self._send(t) if self.size > 1 else t
        self.census.add("all_reduce", site, self._scope,
                        buf.numel() * buf.element_size())
        if self.size == 1:
            return t
        dist.all_reduce(buf, group=self.group)
        return buf.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, site: str,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, at ``t``'s dtype on its device."""
        buf = self._send(t) if self.size > 1 else t
        self.census.add("all_gather", site, self._scope,
                        buf.numel() * buf.element_size() * self.size)
        if self.size == 1:
            return t
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Optional[torch.device | str] = None) -> Mesh:
    """The 1-D mesh over every rank of the process group (one rank per
    process: ``n_devices`` must equal the world size).  ``device``: where
    this rank's tensors live (default: its card under NCCL, else the
    CPU)."""
    world, rank = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"--mesh {n} needs {n} ranks, this run has {world}: launch it "
            f"as torchrun --nproc-per-node {n} -m one_class_ffm_torch ... "
            f"--mesh {n} --distributed (one process per rank)")
    dev = torch.device(device) if device is not None else (
        rank_device() if world > 1 else torch.device("cpu"))
    if dev.type == "cuda" and dev.index is None:
        # this rank's card (torch.cuda.set_device under NCCL)
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(n, rank, dev, axis=axis)


def resolve_mesh(spec: Optional[str],
                 device: Optional[torch.device | str] = None
                 ) -> Optional[Mesh]:
    """A CLI mesh spec as a Mesh (the reference's thread knob, train.cpp:174
    omp_set_num_threads):

      None / ""  -> no mesh (one device)
      "auto"     -> the 1-D data mesh over every rank
      "N", "Nx1" -> the 1-D data mesh; N must equal the world size
      "NxM"      -> a 2-D data x model mesh: ROADMAP A11b
    """
    if not spec:
        return None
    spec = spec.strip().lower()
    if spec == "auto":
        return make_mesh(device=device)
    if "x" in spec:
        nd, nm = (int(t) for t in spec.split("x", 1))
        if nm != 1:
            raise NotImplementedError(
                f"--mesh {spec}: the 2-D data x model mesh (block tables "
                f"row-sharded on the model axis): {A11B}")
        return make_mesh(nd, device=device)
    return make_mesh(int(spec), device=device)


# ---------------------------------------------------------------------------
# placement: each rank's slice of the full host arrays
# ---------------------------------------------------------------------------

# keys of the solver's data dict, by how a rank holds them
_ROWS_U = ("xu_idx", "xu_val", "cnt_u")
_ROWS_V = ("xv_idx", "xv_val", "cnt_v")
_STREAM = ("pos_u", "pos_v", "pos_w")
_BLK_U = ("blk_u_take", "blk_u_src", "blk_u_own", "blk_u_runs", "blk_u_w",
          "blk_u_from_v")
_BLK_V = ("blk_v_take", "blk_v_own", "blk_v_runs", "blk_v_w",
          "blk_v_from_u")
_REPLICATED = ("reg_u", "reg_v", "colsq_u", "colsq_v")
# global stream-order maps of the v side: assembly only (its carry comes
# from the u side's through the cross-order map)
_ASSEMBLY = ("blk_v_src", "blk_v_inv")


def _sliced(a, sl: slice, dev):
    if isinstance(a, tuple):
        return tuple(None if x is None else _sliced(x, sl, dev) for x in a)
    return a[sl].contiguous().to(dev)


def _moved(a, dev):
    if isinstance(a, tuple):
        return tuple(None if x is None else _moved(x, dev) for x in a)
    return a.to(dev)


def shard_data(data: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A rank's part of the solver's data (``make_device_data(...,
    blocked_shards=mesh.size)``, both sides blocked): its rows of each
    side's fields, its slice of the shard-aligned stream, its blocks of
    both layouts, and copies of the per-feature arrays, on
    ``mesh.device``.  Each non-identity field's feature-major list is
    rebuilt over the rank's rows (row ids local to it); the u side's
    stream-to-slot map ``blk_u_inv`` becomes local to the rank's slots.  A
    key of the head tier or of the plain COO passes raises
    ``NotImplementedError`` (ROADMAP A11b)."""
    from ..solver.torch_solver import feature_list

    S, dev = mesh.size, mesh.device
    known = set(_ROWS_U + _ROWS_V + _STREAM + _BLK_U + _BLK_V + _REPLICATED
                + _ASSEMBLY + ("xf_u", "xf_v", "blk_u_inv"))
    extra = sorted(k for k in data if k not in known)
    missing = [k for k in _BLK_U + _BLK_V if k not in data]
    if extra or missing:
        raise NotImplementedError(
            f"a data mesh runs both sides on the blocked layout, without "
            f"the head tier or the plain COO passes (keys {extra or missing})"
            f": {A11B}")
    m, n = data["xu_idx"][0].shape[0], data["xv_idx"][0].shape[0]
    nnz = data["pos_w"].shape[0]
    nb_u, nb_v = data["blk_u_own"].shape[0], data["blk_v_own"].shape[0]
    for what, size in (("user rows", m), ("item rows", n),
                       ("stream entries", nnz), ("u blocks", nb_u),
                       ("v blocks", nb_v)):
        if size % S:
            raise ValueError(f"{size} {what} do not divide the data axis of "
                             f"size {S}")
    su, sv, ss = mesh.rows(m), mesh.rows(n), mesh.rows(nnz)
    out: Dict[str, Any] = {}
    for key in _ROWS_U:
        out[key] = _sliced(data[key], su, dev)
    for key in _ROWS_V:
        out[key] = _sliced(data[key], sv, dev)
    for key in _STREAM:
        out[key] = _sliced(data[key], ss, dev)
    for key in _BLK_U:
        out[key] = _sliced(data[key], mesh.rows(nb_u), dev)
    for key in _BLK_V:
        out[key] = _sliced(data[key], mesh.rows(nb_v), dev)
    for key in _REPLICATED:
        out[key] = _moved(data[key], dev)
    for s, rows in (("u", su), ("v", sv)):
        idx, val = data[f"x{s}_idx"], data[f"x{s}_val"]
        out["xf_" + s] = tuple(
            None if fm is None else feature_list(
                idx[fi][rows].cpu().numpy(), _host_floats(val[fi][rows]),
                fm.feat_ptr.numel() - 1, val[fi].dtype, dev)
            for fi, fm in enumerate(data["xf_" + s]))
    # the u side's stream-to-slot map, local: its stream slice holds only
    # entries of its own slots (pads, weight 0, point at slot 0)
    maxc = data["blk_u_own"].shape[1]
    off = mesh.rank * (nb_u // S) * maxc
    inv = data["blk_u_inv"][ss].to(torch.int64) - off
    out["blk_u_inv"] = torch.where(data["pos_w"][ss] > 0, inv, 0).to(
        torch.int32).to(dev)
    return out


def _host_floats(t: torch.Tensor) -> np.ndarray:
    """A float tensor as numpy, bfloat16 widened to float32 (exact)."""
    return t.to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()


def replicate_params(params, mesh: Mesh):
    """A copy of every block table on this rank's device."""
    return {f12: {name: torch.as_tensor(t).to(mesh.device, copy=True)
                  for name, t in blk.items()}
            for f12, blk in params.items()}


def shard_params_model(params, mesh: Mesh, min_rows: int = 4096,
                       axis: str = "model"):
    """Row-sharded block tables on a ``model`` axis: ROADMAP A11b."""
    raise NotImplementedError(
        f"block tables row-sharded on a model axis: {A11B}")


def shard_state(state: Dict[str, Any], mesh: Mesh,
                axis: str = "data",
                model_min_rows: Optional[int] = None) -> Dict[str, Any]:
    """A rank's part of a solver state built on the full data of the same
    layout: the tables replicated, its rows of P/Q and a/b, its blocks of
    the slot-order carries ``yt_u`` / ``yt_v``.  ``model_min_rows``
    (tables row-sharded on a model axis) raises (ROADMAP A11b)."""
    if model_min_rows is not None:
        shard_params_model(state["params"], mesh, model_min_rows)
    if any(k in state for k in ("yt_u_hd", "yt_v_hd", "yt")):
        raise NotImplementedError(
            f"a head-tier or stream-order carry under a mesh: {A11B}")
    dev = mesh.device
    out = dict(params=replicate_params(state["params"], mesh))
    def part(t):
        t = torch.as_tensor(t)
        return t[mesh.rows(t.shape[0])].contiguous().to(dev)

    for key in ("P", "Q"):
        out[key] = {f12: part(t) for f12, t in state[key].items()}
    for key in ("a", "b", "yt_u", "yt_v"):
        out[key] = part(state[key])
    return out


def host_arrays(tree):
    """The tensors of a state or data tree as numpy arrays (to hand a state
    to ranks in other processes)."""
    if isinstance(tree, dict):
        return {k: host_arrays(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(host_arrays(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree

