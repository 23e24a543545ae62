"""Full-catalog ranking evaluation on one device, in PyTorch.

The port of ``one_class_ffm_tpu/evalx/jax_eval.py`` (single device).  The
reference's rules are kept exactly (ffm.cpp:872-1128): the cumulative K
ladder, P@K = hits / (mt * K) over all test users, nDCG with binary gain and
IDCG over min(#labels, K) terms, train positives left unmasked, cold users
ranked by the popularity prior, ploss over positives with its index guard,
plus AUC.  Ties rank the lowest item index first (the reference's repeated
first-max argmax): ``torch.topk`` promises no tie order, so ranking uses a
stable descending sort.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import PaddedFields
from ..models.blocks import BlockLayout
from ..ops.sparse_ops import project
from ..utils.device import resolve_device
from .numpy_metrics import TOP_K_LADDER

Tensor = torch.Tensor


@dataclass(frozen=True)
class EvalMeta:
    layout: BlockLayout
    mt: int  # padded test user rows
    mt_true: int
    n: int  # item rows (padded)
    n_true: int
    catalog: int  # rankable item ids: min(train label dim, n_true)
    pop_len: int  # popularity vector length (= train label dim)
    top_ks: Tuple[int, ...] = TOP_K_LADDER
    dtype: torch.dtype = torch.float32


def make_eval_data(uva: PaddedFields, va_labels: List[np.ndarray],
                   popular: np.ndarray, n_items: int, n_items_true: int,
                   layout: BlockLayout, dtype: torch.dtype = torch.float32,
                   top_ks: Sequence[int] = TOP_K_LADDER,
                   device: torch.device | str = "cuda",
                   ) -> Tuple[EvalMeta, Dict[str, Any]]:
    """Device tensors for evaluation (jax_eval.make_eval_data), on the card
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    mt_true = len(va_labels)
    mt = uva.m
    catalog = int(min(len(popular), n_items_true))
    max_l = max(1, max((len(l) for l in va_labels), default=1))
    labels = np.full((mt, max_l), -1, dtype=np.int64)
    n_labels = np.zeros(mt, dtype=np.int64)
    for i, l in enumerate(va_labels):
        labels[i, : len(l)] = np.asarray(l, dtype=np.int64)
        n_labels[i] = len(l)
    pop = np.zeros(n_items, dtype=np.float64)
    npop = min(len(popular), n_items)
    pop[:npop] = popular[:npop]
    meta = EvalMeta(layout=layout, mt=mt, mt_true=mt_true, n=n_items,
                    n_true=n_items_true, catalog=catalog,
                    pop_len=len(popular),
                    top_ks=tuple(int(k) for k in top_ks), dtype=dtype)

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt or x.dtype)

    data = dict(
        xva_idx=tuple(t(a) for a in uva.idx),
        xva_val=tuple(t(a, dtype) for a in uva.val),
        labels=t(labels),
        n_labels=t(n_labels),
        cold=t(np.asarray(uva.row_nnz) == 0),
        valid=t((np.arange(mt) < mt_true).astype(np.float64), dtype),
        popular=t(pop, dtype),
    )
    return meta, data


class Evaluator:
    """Bound to one (test set, item side) pair; call ``validate(params, Q,
    bt)`` with the item-side cross-block caches ``Q`` and item self sums
    ``bt`` of the current training state."""

    def __init__(self, meta: EvalMeta, data: Dict[str, Any],
                 chunk: int = 512):
        self.meta = meta
        self.data = data
        self.chunk = int(min(chunk, meta.mt))
        self._n_chunks = -(-meta.mt // self.chunk)

    def _project_users(self, params) -> Tuple[Dict[int, Tensor], Tensor]:
        """Pva per cross block + test-user self sums (init_va/validate,
        ffm.cpp:872-963)."""
        meta, d = self.meta, self.data
        lay = meta.layout
        dev = d["labels"].device
        Pva: Dict[int, Tensor] = {}
        at = torch.zeros(meta.mt, dtype=meta.dtype, device=dev)
        for b in lay.user_self_blocks():
            P = project(d["xva_idx"][b.fi], d["xva_val"][b.fi],
                        params[b.f12]["W"])
            Q = project(d["xva_idx"][b.fj], d["xva_val"][b.fj],
                        params[b.f12]["H"])
            at = at + (P * Q).sum(dim=1)
        for b in lay.cross_blocks():
            Pva[b.f12] = project(d["xva_idx"][b.fi], d["xva_val"][b.fi],
                                 params[b.f12]["W"])
        return Pva, at

    def scores(self, Pva_c, cold_c, Q, bt) -> Tensor:
        """(c, n) scores: bt + sum_c Pva_c Q_c^T, the popularity prior for
        cold users."""
        meta = self.meta
        z = bt[None, :].to(meta.dtype).expand(cold_c.shape[0], meta.n)
        for b in meta.layout.cross_blocks():
            z = z + Pva_c[b.f12] @ Q[b.f12].T
        return torch.where(cold_c[:, None], self.data["popular"][None, :], z)

    def _eval_chunk(self, Pva_c, at_c, labels_c, n_labels_c, cold_c, valid_c,
                    Q, bt):
        """Per-chunk sums of (hits[nk], ndcg[nk], ploss, auc)."""
        meta = self.meta
        dt = meta.dtype
        kmax = min(max(meta.top_ks), meta.catalog)
        z = self.scores(Pva_c, cold_c, Q, bt)

        # ploss over test positives, (1 - z_j - at_i)^2, with the guard
        # j < len(z): warm users score n_true items, cold users pop_len
        lab = labels_c
        lab_ok = (lab >= 0) & torch.where(cold_c[:, None],
                                          lab < meta.pop_len,
                                          lab < meta.n_true)
        z_at = z.gather(1, lab.clamp(0, meta.n - 1))
        diff = 1.0 - z_at - at_c[:, None]
        ploss = (torch.where(lab_ok, diff * diff, torch.zeros_like(diff))
                 * valid_c[:, None]).sum()

        # rank the catalog: stable descending sort = lowest index on ties
        zc = z[:, : meta.catalog]
        top_idx = torch.sort(zc, dim=1, descending=True,
                             stable=True).indices[:, :kmax]
        lab_m = torch.where(lab >= 0, lab, torch.full_like(lab, -2))
        hit = (top_idx[:, :, None] == lab_m[:, None, :]).any(dim=2).to(dt)
        ranks = torch.arange(kmax, device=z.device)
        gains = 1.0 / torch.log2(ranks.to(dt) + 2.0)
        hits_k, ndcg_k = [], []
        for K in meta.top_ks:
            kk = min(K, meta.catalog)
            msk = (ranks < kk).to(dt)
            hits_k.append((hit * msk[None, :] * valid_c[:, None]).sum())
            dcg = (hit * (gains * msk)[None, :]).sum(dim=1)
            idcg = torch.where(
                ranks[None, :] < torch.clamp(n_labels_c[:, None], max=kk),
                gains[None, :], torch.zeros_like(gains)[None, :]).sum(dim=1)
            nd = torch.where(idcg > 0, dcg / idcg.clamp(min=1e-30),
                             torch.zeros_like(dcg))
            ndcg_k.append((nd * valid_c).sum())

        # AUC: in-catalog positives vs every other catalog item
        srt = torch.sort(zc, dim=1).values
        pos_ok = (lab >= 0) & (lab < meta.catalog)
        z_pos = zc.gather(1, lab.clamp(0, meta.catalog - 1))
        lt = torch.searchsorted(srt, z_pos).to(dt)
        rt = torch.searchsorted(srt, z_pos, right=True).to(dt)
        ties = rt - lt - 1.0  # minus self
        npos = pos_ok.sum(dim=1).to(dt)
        inf = torch.full_like(z_pos, float("inf"))
        srt_p = torch.sort(torch.where(pos_ok, z_pos, inf), dim=1).values
        lt_pp = torch.searchsorted(srt_p, z_pos).to(dt)
        rt_pp = torch.searchsorted(srt_p, z_pos, right=True).to(dt)
        tie_pp = rt_pp - lt_pp - 1.0
        per_pos = torch.where(pos_ok, (lt - lt_pp) + 0.5 * (ties - tie_pp),
                              torch.zeros_like(lt))
        denom = npos * (meta.catalog - npos)
        auc_u = torch.where(denom > 0,
                            per_pos.sum(dim=1) / denom.clamp(min=1.0),
                            torch.full_like(denom, 0.5))
        auc = (auc_u * valid_c).sum()
        return torch.stack(hits_k), torch.stack(ndcg_k), ploss, auc

    def validate(self, params, Q, bt) -> Dict[str, float]:
        """Full evaluation pass; the reference's metric dict (fractions,
        not x100) plus AUC."""
        meta, d = self.meta, self.data
        Pva, at = self._project_users(params)
        nk = len(meta.top_ks)
        hits = np.zeros(nk)
        ndcgs = np.zeros(nk)
        ploss = 0.0
        auc = 0.0
        for s in range(self._n_chunks):
            sl = slice(s * self.chunk, (s + 1) * self.chunk)
            h, nd, pl, au = self._eval_chunk(
                {f12: P[sl] for f12, P in Pva.items()}, at[sl],
                d["labels"][sl], d["n_labels"][sl], d["cold"][sl],
                d["valid"][sl], Q, bt)
            hits += h.double().cpu().numpy()
            ndcgs += nd.double().cpu().numpy()
            ploss += float(pl)
            auc += float(au)
        mt = meta.mt_true
        out: Dict[str, float] = {}
        for s_i, K in enumerate(meta.top_ks):
            out[f"p@{K}"] = hits[s_i] / (mt * K)
            out[f"ndcg@{K}"] = ndcgs[s_i] / mt
        out["ploss"] = float(np.sqrt(ploss / mt))
        out["auc"] = auc / mt
        return out
