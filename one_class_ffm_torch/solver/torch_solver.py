"""Alternating Gauss-Newton solver for one-class MF, in PyTorch.

The port of ``one_class_ffm_tpu/solver/jax_solver.py`` for its first slice:
one-class MF with ``--ns`` — identity user-id and item-id fields and cross
(``uv``) blocks only, plain CG, the blocked stream on both sides with the
slot-order residual carry.  The math, the block order, the CG stop rule and
the rounding points are the reference's; the three stream passes run the
hand-written kernels on a CUDA device (ops/sparse_ops.py dispatches).

Out-of-slice configurations raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

The state is a dict of tensors, as in the JAX package: ``params`` ({f12:
{"W", "H"}}), the caches ``P``/``Q`` ({f12: (rows, k)}), the side sums
``a``/``b``, and the residual carried in each side's slot order,
``yt_u``/``yt_v`` ((n_blocks, MAXC)).  Functions return new dicts and never
modify a state they were given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from one_class_ffm_tpu.data.dataset import PaddedFields, PaddedLabels
from one_class_ffm_tpu.models.blocks import BlockInfo, BlockLayout
from one_class_ffm_tpu.solver.params import HyperParams

from ..ops.layout import check_own_runs, make_blocked_layout
from ..ops.sparse_ops import (
    gather_blocked_rows,
    pos_dot,
    pos_gap_blocked,
    pos_hv_blocked,
    pos_scatter_blocked,
)

Tensor = torch.Tensor

# the JAX package's defaults for the blocked layout's skew guard
# (OCFFM_BLK_PAD_RATIO) and two-tier split (OCFFM_HEAD_CHUNK)
_PAD_RATIO = 2.0
_HEAD_CHUNK = 512


@dataclass(frozen=True)
class ProblemMeta:
    """Static problem description (counterpart of the JAX ProblemMeta)."""

    layout: BlockLayout
    hp: HyperParams
    m: int  # padded user rows
    n: int  # padded item rows
    m_true: int
    n_true: int
    dtype: torch.dtype = torch.float32
    ident_u: Tuple[bool, ...] = ()
    ident_v: Tuple[bool, ...] = ()
    blocked_bm_u: int = 0
    blocked_bm_v: int = 0


def _ident_flags(pf: PaddedFields) -> Tuple[bool, ...]:
    """Strict identity-encoded fields: row i's single feature is (idx=i,
    val=1) and the field dim equals the true row count (jax_solver.py
    ident_flags)."""
    out = []
    for fi in range(pf.f):
        idx, val, mt = pf.idx[fi], pf.val[fi], pf.m_true
        out.append(bool(
            idx.shape[1] == 1 and pf.Ds[fi] == mt
            and np.all(idx[:mt, 0] == np.arange(mt))
            and np.all(val[:mt, 0] == 1) and np.all(val[mt:, 0] == 0)))
    return tuple(out)


def make_device_data(u: PaddedFields, v: PaddedFields, y: PaddedLabels,
                     layout: BlockLayout, hp: HyperParams,
                     dtype: torch.dtype = torch.float32,
                     blocked_bm: int = 256,
                     device: torch.device | str = "cpu",
                     ) -> Tuple[ProblemMeta, Dict[str, Any]]:
    """Assemble the device tensor dict + static meta from host padded views
    (jax_solver.make_device_data, restricted to the keys the MF slice
    uses).  Builds the blocked layout of the positive stream for both
    segment sides and checks the contiguous-run property of each."""
    device = torch.device(device)
    if not blocked_bm:
        raise NotImplementedError(
            "blocked_bm=0 (plain COO positive passes): ROADMAP A3")
    pads = np.asarray(y.w) == 0
    blk_u = make_blocked_layout(y.u, y.v, u.m, blocked_bm,
                                max_pad_ratio=_PAD_RATIO, drop=pads,
                                head_chunk=_HEAD_CHUNK)
    blk_v = make_blocked_layout(y.v, y.u, v.m, blocked_bm,
                                max_pad_ratio=_PAD_RATIO, drop=pads,
                                head_chunk=_HEAD_CHUNK)
    for side, b in (("u", blk_u), ("v", blk_v)):
        if b is None:
            raise NotImplementedError(
                f"no blocked layout for the {side} side (row count not a "
                f"multiple of {blocked_bm}, or skew beyond the pad budget): "
                "the plain COO positive passes are ROADMAP A3")
        if "hd_row" in b:
            raise NotImplementedError(
                f"the {side} side's layout needs the two-tier head tier "
                "(popularity skew): ROADMAP A9")
        check_own_runs(b["own"], blocked_bm)

    meta = ProblemMeta(
        layout=layout, hp=hp, m=u.m, n=v.m, m_true=u.m_true, n_true=v.m_true,
        dtype=dtype, ident_u=_ident_flags(u),
        ident_v=_ident_flags(v), blocked_bm_u=blocked_bm,
        blocked_bm_v=blocked_bm)

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt or x.dtype)

    def regs(pf: PaddedFields):
        if hp.freq:
            return tuple(t(fr, dtype) for fr in pf.freq)
        return tuple(torch.ones(d, dtype=dtype, device=device)
                     for d in pf.Ds)

    data: Dict[str, Any] = dict(
        xu_idx=tuple(t(a) for a in u.idx),
        xu_val=tuple(t(a, dtype) for a in u.val),
        xv_idx=tuple(t(a) for a in v.idx),
        xv_val=tuple(t(a, dtype) for a in v.val),
        pos_u=t(y.u), pos_v=t(y.v), pos_w=t(y.w, dtype),
        cnt_u=t(y.count_u, dtype), cnt_v=t(y.count_v, dtype),
        reg_u=regs(u), reg_v=regs(v),
    )
    for pre, b in (("blk_u_", blk_u), ("blk_v_", blk_v)):
        data[pre + "take"] = t(b["take"])
        data[pre + "src"] = t(b["src"])
        data[pre + "own"] = t(b["own"])
        # pre-permuted pad-mask weights, exactly 0 at structural pad slots:
        # also the slot-order pad mask of the residual carry
        data[pre + "w"] = t(y.w[b["src"]] * (b["own"] < b["block_rows"]),
                            dtype)
        data[pre + "inv"] = t(b["inv"])
    # cross-order slot maps of the residual carry: for each slot of one
    # side's layout, the flat slot index of the same entry on the other side
    data["blk_u_from_v"] = t(blk_v["inv"][blk_u["src"]])
    data["blk_v_from_u"] = t(blk_u["inv"][blk_v["src"]])
    return meta, data


class FFMSolver:
    """Solver bound to one problem instance (MF slice).

    Usage:
        solver = FFMSolver(meta, data)
        state = solver.init(torch.Generator(device).manual_seed(0))
        state = solver.epoch(state)
    """

    def __init__(self, meta: ProblemMeta, data: Dict[str, Any],
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError("multi-device runs: ROADMAP A11")
        hp = meta.hp
        if meta.layout.user_self_blocks() or meta.layout.item_self_blocks():
            raise NotImplementedError(
                "self blocks (the model without --ns): ROADMAP A4")
        if not all(meta.ident_u) or not all(meta.ident_v):
            raise NotImplementedError(
                "non-identity fields (FM/FFM feature fields): ROADMAP A4")
        self.cg_precond = "none" if hp.cg_precond == "auto" else hp.cg_precond
        if self.cg_precond == "jacobi":
            raise NotImplementedError("cg_precond='jacobi': ROADMAP A10")
        if self.cg_precond != "none":
            raise ValueError(f"unknown cg_precond {hp.cg_precond!r}")
        if not (meta.blocked_bm_u and meta.blocked_bm_v):
            raise NotImplementedError(
                "the plain COO positive passes: ROADMAP A3")
        self.meta = meta
        self.data = data
        self.blocks: List[BlockInfo] = meta.layout.all_blocks()
        self.device = data["pos_u"].device

    # -- field accessors ------------------------------------------------------

    def _side(self, b: BlockInfo, first: bool):
        """(reg, padded rows, true rows) of the block's f1 or f2 side."""
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        if fg < self.meta.layout.fu:
            return self.data["reg_u"][fl], self.meta.m, self.meta.m_true
        return self.data["reg_v"][fl], self.meta.n, self.meta.n_true

    def _proj(self, b: BlockInfo, first: bool, T: Tensor) -> Tensor:
        """X_side @ T for an identity field: the table zero-padded to the
        row count (table pad rows are zero by invariant)."""
        _, rows, _ = self._side(b, first)
        if T.shape[0] == rows:
            return T
        return torch.nn.functional.pad(T, (0, 0, 0, rows - T.shape[0]))

    def _scat(self, b: BlockInfo, first: bool, Z: Tensor, dim: int) -> Tensor:
        """X_side^T @ Z for an identity field: row d receives row d."""
        return Z[:dim]

    # -- init -----------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random block tables + all caches (reference init, ffm.cpp:467-512):
        tables ~ U(-0.1/sqrt(k), 0.1/sqrt(k)).  jax.random bits cannot be
        reproduced; only the law is the same."""
        meta = self.meta
        k = meta.hp.k
        scale = 0.1 / math.sqrt(k)

        def table(d):
            u = torch.rand((d, k), generator=generator, device=self.device,
                           dtype=torch.float32)
            return ((2.0 * u - 1.0) * scale).to(meta.dtype)

        params = {b.f12: dict(W=table(b.d1), H=table(b.d2))
                  for b in self.blocks}
        return self.refresh_caches({"params": params})

    def refresh_caches(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """(Re)build P/Q, the side sums a/b and the slot-order residual carry
        from the tables: used at init and after loading a checkpoint."""
        params = state["params"]
        P, Q = {}, {}
        for b in self.blocks:
            P[b.f12] = self._proj(b, True, params[b.f12]["W"])
            Q[b.f12] = self._proj(b, False, params[b.f12]["H"])
        a, b_vec = self._side_sums(P, Q)
        yt = self._pos_scores(P, Q, a, b_vec) - 1.0
        d = self.data
        return dict(params=params, P=P, Q=Q, a=a, b=b_vec,
                    yt_u=yt[d["blk_u_src"].long()] * d["blk_u_w"],
                    yt_v=yt[d["blk_v_src"].long()] * d["blk_v_w"])

    def yt_stream(self, state) -> Tensor:
        """The positive residual in stream order, pad-masked (diagnostics and
        the objective; the epoch works on the slot-order carry)."""
        d = self.data
        return (state["yt_u"].reshape(-1)[d["blk_u_inv"].long()]
                * d["pos_w"])

    def _side_sums(self, P, Q) -> Tuple[Tensor, Tensor]:
        """a_i / b_j self-interaction sums (calc_side, ffm.cpp:360-373)."""
        meta = self.meta
        a = torch.zeros(meta.m, dtype=meta.dtype, device=self.device)
        b_vec = torch.zeros(meta.n, dtype=meta.dtype, device=self.device)
        for blk in meta.layout.user_self_blocks():
            a = a + (P[blk.f12] * Q[blk.f12]).sum(dim=1)
        for blk in meta.layout.item_self_blocks():
            b_vec = b_vec + (P[blk.f12] * Q[blk.f12]).sum(dim=1)
        return a, b_vec

    def _pos_scores(self, P, Q, a, b_vec) -> Tensor:
        """yhat at every positive pair (init_y_tilde, ffm.cpp:388-403)."""
        d = self.data
        u, v = d["pos_u"].long(), d["pos_v"].long()
        z = a[u.clamp(max=a.shape[0] - 1)] + b_vec[v.clamp(max=b_vec.shape[0] - 1)]
        for blk in self.meta.layout.cross_blocks():
            z = z + pos_dot(P[blk.f12], u, Q[blk.f12], v)
        return z

    def _cache_sasb(self, P, Q) -> Tuple[Tensor, Tensor]:
        """sa_i = sum_j cross(i, j), sb_j = sum_i cross(i, j) (cache_sasb,
        ffm.cpp:514-535).  Only self-block gradients read them, so the MF
        epoch does not build them."""
        meta = self.meta
        sa = torch.zeros(meta.m, dtype=meta.dtype, device=self.device)
        sb = torch.zeros(meta.n, dtype=meta.dtype, device=self.device)
        for blk in meta.layout.cross_blocks():
            Pb, Qb = P[blk.f12], Q[blk.f12]
            sa = sa + Pb @ Qb.sum(dim=0)
            sb = sb + Qb @ Pb.sum(dim=0)
        return sa, sb

    def _pos_coeff(self, yt: Tensor) -> Tensor:
        """Per-positive gradient coefficient (1-w) yt - w (1-r)
        (ffm.cpp:577-579, 684)."""
        hp = self.meta.hp
        return (1.0 - hp.omega) * yt - hp.omega * (1.0 - hp.r)

    # -- gradient and Hv --------------------------------------------------------

    def _blk(self, first: bool):
        """(key prefix, output rows, block rows) of a side's blocked layout."""
        meta = self.meta
        if first:
            return "blk_u_", meta.m, meta.blocked_bm_u
        return "blk_v_", meta.n, meta.blocked_bm_v

    def _grad_cross(self, state, b: BlockInfo, first: bool,
                    rows_pre: Tensor) -> Tensor:
        """Gradient for one table of a cross block (gd_cross, ffm.cpp:630-703):
        omega part via k x k Grams, positive part by the scatter kernel over
        the pre-gathered stream."""
        meta, d = self.meta, self.data
        hp = meta.hp
        reg, _, _ = self._side(b, first)
        T = state["params"][b.f12]["W" if first else "H"]
        pre, num, bm = self._blk(first)
        c_blk = self._pos_coeff(state["yt_u" if first else "yt_v"]) \
            * d[pre + "w"]
        if first:
            own_c, oth_c, side, oth_vec = state["P"], state["Q"], state["a"], \
                state["b"]
        else:
            own_c, oth_c, side, oth_vec = state["Q"], state["P"], state["b"], \
                state["a"]
        B1 = oth_c[b.f12]
        oQ = B1.sum(dim=0)
        bQ = B1.T @ oth_vec
        gram_T = torch.zeros((num, hp.k), dtype=meta.dtype, device=self.device)
        for blk in meta.layout.cross_blocks():
            gram_T = gram_T + own_c[blk.f12] @ (oth_c[blk.f12].T @ B1)
        dense = hp.omega * ((side - hp.r)[:, None] * oQ[None, :]
                            + bQ[None, :] + gram_T)
        zpos = pos_scatter_blocked(c_blk, rows_pre, d[pre + "own"], num, bm)
        return hp.lam * reg[:, None] * T + self._scat(
            b, first, dense + zpos, T.shape[0])

    def _hv_cross(self, state, b: BlockInfo, first: bool, rows_pre: Tensor):
        """Hv closure for a cross-block table (hs_cross, ffm.cpp:706-742):
        one kernel pass per call, the omega Q1^T Q1 term fused into it."""
        meta, d = self.meta, self.data
        hp = meta.hp
        reg, _, _ = self._side(b, first)
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        pre, num, bm = self._blk(first)
        dmat = (hp.omega * (B1.T @ B1)).to(meta.dtype)
        own, w_blk = d[pre + "own"], d[pre + "w"]
        w_scale = 1.0 - hp.omega

        def hv(V: Tensor) -> Tensor:
            phi = self._proj(b, first, V)
            zp = pos_hv_blocked(phi, rows_pre, own, w_blk, dmat, num, bm,
                                w_scale)
            return hp.lam * reg[:, None] * V + self._scat(b, first, zp, dim)

        return hv

    # -- conjugate gradient -----------------------------------------------------

    def _cg(self, hv, G: Tensor) -> Tuple[Tensor, int]:
        """Newton-step CG (cg, ffm.cpp:744-813): stop when ||r||^2 <=
        cg_eps ||g||^2 or after cg_max_iter iterations.  The recurrence runs
        at a float32 floor; Hv is evaluated at storage dtype.  One host sync
        per iteration reads the stop condition."""
        hp = self.meta.hp
        storage = self.meta.dtype
        ct = torch.promote_types(G.dtype, torch.float32)
        Gc = G.to(ct)
        g2 = (Gc * Gc).sum()
        S = torch.zeros_like(Gc)
        R = -Gc
        V = -Gc
        r2 = g2
        it = 0
        one = torch.ones((), dtype=ct, device=Gc.device)
        zero = torch.zeros((), dtype=ct, device=Gc.device)
        while it < hp.cg_max_iter and bool(r2 > hp.cg_eps * g2):
            Hv = hv(V.to(storage)).to(ct)
            den = (V * Hv).sum()
            # degenerate-denominator guard (jax_solver.py:2022-2029): a
            # converged f32 block can underflow V.Hv to 0 — take no step
            # and force the stop instead of writing inf/nan
            ok = den > 0
            alpha = torch.where(ok, r2 / torch.where(ok, den, one), zero)
            S = S + alpha * V
            R = R - alpha * Hv
            r2_new = torch.where(ok, (R * R).sum(), zero)
            V = R + (r2_new / torch.where(r2 > 0, r2, one)) * V
            r2 = r2_new
            it += 1
        return S, it

    # -- block update -----------------------------------------------------------

    def _apply_step(self, state, b: BlockInfo, first: bool, S: Tensor,
                    rows_pre: Tensor) -> Dict[str, Any]:
        """Apply the Newton step and refresh the cache and both sides' slot-
        order residuals (update_cross, ffm.cpp:439-465).  The gap kernel
        reuses the solve's stream: the other side's cache did not move."""
        meta, d = self.meta, self.data
        key, cache_key = ("W", "P") if first else ("H", "Q")
        state = dict(state)
        params = dict(state["params"])
        blk_params = dict(params[b.f12])
        # S arrives at the CG float32 floor: sum, then round once
        blk_params[key] = (blk_params[key] + S).to(meta.dtype)
        params[b.f12] = blk_params
        state["params"] = params

        S = S.to(meta.dtype)
        dP = self._proj(b, first, S)
        caches = dict(state[cache_key])
        caches[b.f12] = caches[b.f12] + dP
        state[cache_key] = caches

        pre, _, bm = self._blk(first)
        gap = pos_gap_blocked(dP, rows_pre, d[pre + "own"], bm)
        own_key, oth_key = ("yt_u", "yt_v") if first else ("yt_v", "yt_u")
        oth_pre = "blk_v_" if first else "blk_u_"
        state[own_key] = state[own_key] + gap.reshape(
            state[own_key].shape) * d[pre + "w"]
        cross = d["blk_v_from_u" if first else "blk_u_from_v"].long()
        state[oth_key] = state[oth_key] + gap[cross] * d[oth_pre + "w"]
        return state

    def _solve_half(self, state, b: BlockInfo, first: bool):
        """Gradient, CG and step for one table of a cross block.  The other
        side's cache is constant for the solve: its blocked stream is
        gathered once and every pass streams it."""
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        pre, _, _ = self._blk(first)
        rows_pre = gather_blocked_rows(B1, self.data[pre + "take"])
        G = self._grad_cross(state, b, first, rows_pre)
        S, it = self._cg(self._hv_cross(state, b, first, rows_pre), G)
        return self._apply_step(state, b, first, S, rows_pre), it

    # -- epoch ------------------------------------------------------------------

    def _epoch_impl(self, state):
        """One alternating sweep in reference order (one_epoch,
        ffm.cpp:852-870): per block the f1 table, then the f2 table."""
        iters = []
        for b in self.meta.layout.epoch_order():
            state, it1 = self._solve_half(state, b, True)
            state, it2 = self._solve_half(state, b, False)
            iters.extend((it1, it2))
        return state, torch.tensor(iters, dtype=torch.int32)

    def epoch(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self._epoch_impl(state)[0]

    def epoch_stats(self, state):
        """(new state, per-solve CG iteration counts in epoch_order with the
        f1 then f2 half of each block adjacent)."""
        return self._epoch_impl(state)

    # -- diagnostics ------------------------------------------------------------

    def objective(self, state: Dict[str, Any]) -> Tensor:
        """Exact loss via the rank-k decomposition (the reference's func(),
        ffm.cpp:1321-1351, without materializing m x n)."""
        meta, d = self.meta, self.data
        hp = meta.hp
        P, Q, a, b_vec = state["P"], state["Q"], state["a"], state["b"]
        yt = self.yt_stream(state)
        m, n = meta.m_true, meta.n_true
        at, bt = a[:m], b_vec[:n]
        cross = meta.layout.cross_blocks()
        alpha = at - hp.r
        sumP = {c.f12: P[c.f12][:m].sum(dim=0) for c in cross}
        sumQ = {c.f12: Q[c.f12][:n].sum(dim=0) for c in cross}
        e2 = n * (alpha ** 2).sum() + m * (bt ** 2).sum()
        e2 = e2 + 2.0 * alpha.sum() * bt.sum()
        Pcat = torch.cat([P[c.f12][:m] for c in cross], dim=1)
        Qcat = torch.cat([Q[c.f12][:n] for c in cross], dim=1)
        e2 = e2 + ((Pcat.T @ Pcat) * (Qcat.T @ Qcat)).sum()
        for c in cross:
            e2 = e2 + 2.0 * (alpha @ (P[c.f12][:m] @ sumQ[c.f12]))
            e2 = e2 + 2.0 * (bt @ (Q[c.f12][:n] @ sumP[c.f12]))
        w = d["pos_w"]
        y_minus_r = yt + (1.0 - hp.r)
        loss = hp.omega * (e2 - (w * y_minus_r ** 2).sum()) \
            + (w * yt ** 2).sum()
        for b in self.blocks:
            reg1, _, _ = self._side(b, True)
            reg2, _, _ = self._side(b, False)
            prm = state["params"][b.f12]
            loss = loss + hp.lam * (reg1[:, None] * prm["W"] ** 2).sum()
            loss = loss + hp.lam * (reg2[:, None] * prm["H"] ** 2).sum()
        return 0.5 * loss
