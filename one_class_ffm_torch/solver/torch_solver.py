"""Alternating Gauss-Newton solver for one-class FFM / FM / MF, in PyTorch.

The port of ``one_class_ffm_tpu/solver/jax_solver.py`` on one device, plain
CG, the blocked stream on both sides with the slot-order residual carry.
A field is an identity id field (X is the identity: projection and scatter
are a pad and a slice), a non-identity feature field with at most
``FUSED_TBL_D`` features, whose solves run the fused table-space passes
(the JAX package's ``_fused_tbl_side`` rule, without its TPU memory gates),
or a wider feature field, whose solves project through B8 (``project``)
and scatter through the X^T stage (``scatter``) around the blocked stream
passes, as the JAX package's non-fused branches do.  Every non-identity
field's projections (init, refresh, each step's dP) go through B8.  Cross
(``uv``) and self (``uu``/``vv``) blocks are both ported.
The math, the block order, the CG stop rule and the rounding points are
the reference's; the stream and table passes run the hand-written kernels
on a CUDA device (ops/sparse_ops.py dispatches).

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

from ..data.dataset import PaddedFields, PaddedLabels
from ..models.blocks import BlockInfo, BlockLayout
from ..ops.layout import (
    FeatureMajor,
    check_own_runs,
    feature_major,
    make_blocked_layout,
)
from ..ops.sparse_ops import (
    acc_dtype,
    expand_rows_blocked,
    gather_blocked_rows,
    grad_cross_tbl,
    grad_self_tbl,
    hv_self_tbl,
    pos_dot,
    pos_gap_blocked,
    pos_hv_blocked,
    pos_hv_tbl,
    pos_scatter_blocked,
    project,
    scatter,
    seg_sum_blocked,
)
from .params import HyperParams

Tensor = torch.Tensor

# the JAX package's defaults for the blocked layout's skew guard
# (OCFFM_BLK_PAD_RATIO) and two-tier split (OCFFM_HEAD_CHUNK)
_PAD_RATIO = 2.0
_HEAD_CHUNK = 512
# largest field dim whose solves run the fused table-space passes (the JAX
# package's OCFFM_FUSED_TBL_D default); a wider non-identity field projects
# and scatters around the blocked passes
FUSED_TBL_D = 4096


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
    # per field: non-identity with D <= FUSED_TBL_D (JAX _fused_field) — its
    # solves run the fused table passes; every non-identity field has its
    # feature-major list in data["xf_u"/"xf_v"]
    fused_u: Tuple[bool, ...] = ()
    fused_v: Tuple[bool, ...] = ()
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
    (jax_solver.make_device_data, restricted to the keys the port uses).
    Builds the blocked layout of the positive stream for both segment sides
    and checks the contiguous-run property of each.  For each non-identity
    field it builds the feature-major list of its X (``xf_u``/``xf_v``,
    None for an identity field): the static X^T side of the fused table
    kernels (in place of the JAX package's transposed (p, rows) copies) and
    of the general scatter.  Building it rejects ids outside the field
    (ghost ids)."""
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

    ident_u, ident_v = _ident_flags(u), _ident_flags(v)

    def fused(pf: PaddedFields, ident):
        return tuple(not i and d <= FUSED_TBL_D
                     for i, d in zip(ident, pf.Ds))

    meta = ProblemMeta(
        layout=layout, hp=hp, m=u.m, n=v.m, m_true=u.m_true, n_true=v.m_true,
        dtype=dtype, ident_u=ident_u, ident_v=ident_v,
        fused_u=fused(u, ident_u), fused_v=fused(v, ident_v),
        blocked_bm_u=blocked_bm, blocked_bm_v=blocked_bm)

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt or x.dtype)

    def regs(pf: PaddedFields):
        if hp.freq:
            return tuple(t(fr, dtype) for fr in pf.freq)
        return tuple(torch.ones(d, dtype=dtype, device=device)
                     for d in pf.Ds)

    def xf(pf: PaddedFields, flags):
        out = []
        for fi, on in enumerate(flags):
            fm = feature_major(pf.idx[fi], pf.val[fi], pf.Ds[fi]) if on \
                else None
            out.append(None if fm is None else FeatureMajor(
                row=t(fm.row), val=t(fm.val, dtype),
                chunk_ptr=t(fm.chunk_ptr), feat_ptr=t(fm.feat_ptr),
                n_rows=fm.n_rows))
        return tuple(out)

    data: Dict[str, Any] = dict(
        xu_idx=tuple(t(a) for a in u.idx),
        xu_val=tuple(t(a, dtype) for a in u.val),
        xv_idx=tuple(t(a) for a in v.idx),
        xv_val=tuple(t(a, dtype) for a in v.val),
        xf_u=xf(u, [not i for i in ident_u]),
        xf_v=xf(v, [not i for i in ident_v]),
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
    """Solver bound to one problem instance.

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

    def _u_field(self, b: BlockInfo, first: bool) -> Tuple[bool, int]:
        """(on the user side?, field index within its side) of the block's
        f1 or f2 side."""
        fg = b.f1 if first else b.f2
        return fg < self.meta.layout.fu, b.fi if first else b.fj

    def _side(self, b: BlockInfo, first: bool):
        """(reg, padded rows, true rows) of the block's f1 or f2 side."""
        u_side, fl = self._u_field(b, first)
        if u_side:
            return self.data["reg_u"][fl], self.meta.m, self.meta.m_true
        return self.data["reg_v"][fl], self.meta.n, self.meta.n_true

    def _x(self, b: BlockInfo, first: bool):
        """(x_idx, x_val, feature-major list) of the block side's field;
        the list is None for an identity field."""
        u_side, fl = self._u_field(b, first)
        s = "u" if u_side else "v"
        d = self.data
        return d[f"x{s}_idx"][fl], d[f"x{s}_val"][fl], d[f"xf_{s}"][fl]

    def _fused(self, b: BlockInfo, first: bool) -> bool:
        """True when the block side's field runs the fused table passes."""
        u_side, fl = self._u_field(b, first)
        return (self.meta.fused_u if u_side else self.meta.fused_v)[fl]

    def _proj(self, b: BlockInfo, first: bool, T: Tensor) -> Tensor:
        """X_side @ T: the projection B8 for a feature field; for an
        identity field the table zero-padded to the row count (table pad
        rows are zero by invariant)."""
        idx, val, xf = self._x(b, first)
        if xf is not None:
            return project(idx, val, T)
        _, rows, _ = self._side(b, first)
        if T.shape[0] == rows:
            return T
        return torch.nn.functional.pad(T, (0, 0, 0, rows - T.shape[0]))

    def _scat(self, b: BlockInfo, first: bool, Z: Tensor, dim: int) -> Tensor:
        """X_side^T @ Z at storage dtype: for an identity field row d
        receives row d; a wide feature field scatters through its
        feature-major list (pad rows carry val == 0 and are not in it, so
        nothing is masked).  A small-D field's solves scatter inside the
        fused table passes."""
        _, _, xf = self._x(b, first)
        if xf is not None:
            return scatter(xf, Z)
        return Z[:dim]

    def _tbl_grad(self, b: BlockInfo, first: bool, T: Tensor,
                  Gt: Tensor) -> Tensor:
        """lam reg T + Gt at the float32 floor: a fused pass's table-space
        output stays unrounded through the gradient (jax_solver.py:1183-1195;
        rounding it was the bf16 divergence of the reference's round 5)."""
        reg, _, _ = self._side(b, first)
        acc = acc_dtype(self.meta.dtype)
        return (self.meta.hp.lam * (reg.to(acc)[:, None] * T.to(acc))
                + Gt.to(acc))

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
        ffm.cpp:514-535); only self-block gradients read them."""
        meta = self.meta
        sa = torch.zeros(meta.m, dtype=meta.dtype, device=self.device)
        sb = torch.zeros(meta.n, dtype=meta.dtype, device=self.device)
        for blk in meta.layout.cross_blocks():
            Pb, Qb = P[blk.f12], Q[blk.f12]
            sa = sa + Pb @ Qb.sum(dim=0)
            sb = sb + Qb @ Pb.sum(dim=0)
        return sa, sb

    def sasb(self, state):
        """(sa, sb) for an epoch's self-block gradients, or (None, None)
        for a model without self blocks, which never reads them."""
        lay = self.meta.layout
        if lay.user_self_blocks() or lay.item_self_blocks():
            return self._cache_sasb(state["P"], state["Q"])
        return None, None

    def _pos_coeff(self, yt: Tensor) -> Tensor:
        """Per-positive gradient coefficient (1-w) yt - w (1-r)
        (ffm.cpp:577-579, 684)."""
        hp = self.meta.hp
        return (1.0 - hp.omega) * yt - hp.omega * (1.0 - hp.r)

    # -- gradient and Hv --------------------------------------------------------

    def _blk(self, u_side: bool):
        """(key prefix, output rows, block rows) of a side's blocked layout."""
        meta = self.meta
        if u_side:
            return "blk_u_", meta.m, meta.blocked_bm_u
        return "blk_v_", meta.n, meta.blocked_bm_v

    def _grad_cross(self, state, b: BlockInfo, first: bool,
                    rows_pre: Tensor) -> Tensor:
        """Gradient for one table of a cross block (gd_cross, ffm.cpp:630-703):
        omega part via k x k Grams, positive part by the scatter kernel over
        the pre-gathered stream; on a small-D feature field both go to table
        space in one fused pass, on a wide one the X^T stage scatters them."""
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
        _, _, xf = self._x(b, first)
        if self._fused(b, first):
            return self._tbl_grad(b, first, T, grad_cross_tbl(
                xf, rows_pre, d[pre + "own"], c_blk, dense, bm))
        zpos = pos_scatter_blocked(c_blk, rows_pre, d[pre + "own"], num, bm)
        return hp.lam * reg[:, None] * T + self._scat(
            b, first, dense + zpos, T.shape[0])

    def _grad_self(self, state, b: BlockInfo, first: bool, sa: Tensor,
                   sb: Tensor) -> Tensor:
        """Gradient for one table of a self block (gd_side, ffm.cpp:537-592):

            z_i = w [ n (a_i - r) + sum(b) + sa_i ] + sum_{j in pos_i} c_ij
            G   = lam reg T + X1^T diag(z) Q1

        The per-row positive sums run over the slot-order carry of the
        block's side; on a small-D feature field they, the dense term and
        the X^T scatter are one fused pass."""
        meta, d = self.meta, self.data
        hp = meta.hp
        T = state["params"][b.f12]["W" if first else "H"]
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        u_side = b.kind == "uu"
        if u_side:
            n_other, side, s_cache, other_sum = (
                meta.n_true, state["a"], sa, state["b"].sum())
        else:
            n_other, side, s_cache, other_sum = (
                meta.m_true, state["b"], sb, state["a"].sum())
        pre, num, bm = self._blk(u_side)
        c_blk = self._pos_coeff(state["yt_u" if u_side else "yt_v"]) \
            * d[pre + "w"]
        zdense = hp.omega * (n_other * (side - hp.r) + other_sum + s_cache)
        _, _, xf = self._x(b, first)
        if self._fused(b, first):
            return self._tbl_grad(b, first, T, grad_self_tbl(
                xf, Q1, zdense, d[pre + "own"], c_blk, bm))
        z = zdense + seg_sum_blocked(c_blk, d[pre + "own"], num, bm)
        reg, _, _ = self._side(b, first)
        return hp.lam * reg[:, None] * T + self._scat(
            b, first, z[:, None] * Q1, T.shape[0])

    def _hv_cross(self, state, b: BlockInfo, first: bool, rows_pre: Tensor):
        """Hv closure for a cross-block table (hs_cross, ffm.cpp:706-742):
        one kernel pass per call, the omega Q1^T Q1 term fused into it (and
        on a small-D feature field the projection and the X^T scatter too;
        a wide field projects with B8 before it and scatters after it)."""
        meta, d = self.meta, self.data
        hp = meta.hp
        reg, _, _ = self._side(b, first)
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        pre, num, bm = self._blk(first)
        dmat = (hp.omega * (B1.T @ B1)).to(meta.dtype)
        own, w_blk = d[pre + "own"], d[pre + "w"]
        w_scale = 1.0 - hp.omega
        idx, val, xf = self._x(b, first)
        fused = self._fused(b, first)

        def hv(V: Tensor) -> Tensor:
            if fused:
                G = pos_hv_tbl(V, idx, val, xf, rows_pre, own, w_blk, dmat,
                               bm, w_scale)
                return hp.lam * reg[:, None] * V + G.to(V.dtype)
            zp = pos_hv_blocked(self._proj(b, first, V), rows_pre, own,
                                w_blk, dmat, num, bm, w_scale)
            return hp.lam * reg[:, None] * V + self._scat(b, first, zp, dim)

        return hv

    def _hv_self(self, state, b: BlockInfo, first: bool):
        """Hv closure for a self-block table (hs_side, ffm.cpp:594-628):
        d_i = (1-w)|pos_i| + w n;  Hv = lam reg V + X1^T diag(d <Q1, X1 V>)
        Q1 — one fused table pass per call on a small-D feature field, B8
        and the X^T stage on a wide one."""
        meta, d = self.meta, self.data
        hp = meta.hp
        reg, _, _ = self._side(b, first)
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        if b.kind == "uu":
            dd = (1.0 - hp.omega) * d["cnt_u"] + hp.omega * meta.n_true
        else:
            dd = (1.0 - hp.omega) * d["cnt_v"] + hp.omega * meta.m_true
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        idx, val, xf = self._x(b, first)
        fused = self._fused(b, first)

        def hv(V: Tensor) -> Tensor:
            if fused:
                G = hv_self_tbl(V, idx, val, xf, Q1, dd)
                return hp.lam * reg[:, None] * V + G.to(V.dtype)
            s = dd * (Q1 * self._proj(b, first, V)).sum(dim=1)
            return hp.lam * reg[:, None] * V + self._scat(
                b, first, s[:, None] * Q1, dim)

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
                    rows_pre: Optional[Tensor]) -> Dict[str, Any]:
        """Apply the Newton step and refresh the cache and both sides' slot-
        order residuals (update_cross ffm.cpp:439-465, update_side 405-437).
        A cross step's gap kernel reuses the solve's stream: the other
        side's cache did not move.  A self step moves the side sum a (or b)
        by <dP, other cache> per row, and every positive of the row by the
        same amount."""
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

        if b.kind == "uv":
            pre, _, bm = self._blk(first)
            gap = pos_gap_blocked(dP, rows_pre, d[pre + "own"], bm)
            own_key, oth_key = ("yt_u", "yt_v") if first else ("yt_v", "yt_u")
            oth_pre = "blk_v_" if first else "blk_u_"
            state[own_key] = state[own_key] + gap.reshape(
                state[own_key].shape) * d[pre + "w"]
            cross = d["blk_v_from_u" if first else "blk_u_from_v"].long()
            state[oth_key] = state[oth_key] + gap[cross] * d[oth_pre + "w"]
            return state
        other = state["Q"][b.f12] if first else state["P"][b.f12]
        da = (dP * other).sum(dim=1)
        own, oth = ("u", "v") if b.kind == "uu" else ("v", "u")
        side_key = "a" if b.kind == "uu" else "b"
        state[side_key] = state[side_key] + da
        pre, _, bm = self._blk(b.kind == "uu")
        # own side: da per slot of its row; other side: the other layout's
        # take IS this side's row id in that slot order (one scalar gather)
        state["yt_" + own] = state["yt_" + own] + expand_rows_blocked(
            da, d[pre + "own"], bm).reshape(state["yt_" + own].shape)
        state["yt_" + oth] = state["yt_" + oth] \
            + da[d[f"blk_{oth}_take"].long()] * d[f"blk_{oth}_w"]
        return state

    def grad_and_hv(self, state, b: BlockInfo, first: bool, sa, sb):
        """(gradient, Hv closure, the solve's stream or None) for one table
        of a block.  In a cross solve the other side's cache is constant:
        its blocked stream is gathered once and every pass streams it."""
        if b.kind != "uv":
            return (self._grad_self(state, b, first, sa, sb),
                    self._hv_self(state, b, first), None)
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        pre, _, _ = self._blk(first)
        rows_pre = gather_blocked_rows(B1, self.data[pre + "take"])
        return (self._grad_cross(state, b, first, rows_pre),
                self._hv_cross(state, b, first, rows_pre), rows_pre)

    def _solve_half(self, state, b: BlockInfo, first: bool, sa, sb):
        """Gradient, CG and step for one table of a block."""
        G, hv, rows_pre = self.grad_and_hv(state, b, first, sa, sb)
        S, it = self._cg(hv, G)
        return self._apply_step(state, b, first, S, rows_pre), it

    # -- epoch ------------------------------------------------------------------

    def _epoch_impl(self, state):
        """One alternating sweep in reference order (one_epoch,
        ffm.cpp:852-870): per block the f1 table, then the f2 table.  sa/sb
        are built once, at the start (jax_solver.py:2304-2312): only
        self-block gradients read them, and a model without self blocks
        skips them."""
        lay = self.meta.layout
        sa, sb = self.sasb(state)
        iters = []
        for b in lay.epoch_order():
            state, it1 = self._solve_half(state, b, True, sa, sb)
            state, it2 = self._solve_half(state, b, False, sa, sb)
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
