"""Alternating Gauss-Newton solver for one-class FFM / FM / MF, in PyTorch.

The port of ``one_class_ffm_tpu/solver/jax_solver.py`` on one device, plain
or Jacobi-preconditioned CG.  Each segment side of the positive stream
takes the blocked layout where it applies (both sides, with the slot-order
residual carry), or the plain COO positive passes (``blocked_bm=0``, or a
side the blocked builder rejects even with the head tier): that side's
positive sums run through its destination-major list of the stream
(``layout.coo_list``), its carry is in stream order, and its fields take no
fused table pass.
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
on a CUDA device (ops/sparse_ops.py dispatches).  A popularity-skewed side
takes the two-tier layout: the kernels run on its tail, and the head ops
(``sparse_ops.head_*``, plain torch) add its power rows' entries.

On a data mesh (``parallel.mesh``; one process per rank on
``torch.distributed``) each rank holds its rows, its slice of the
shard-aligned stream and its part of each side's order (``make_device_data(
..., blocked_shards=S)``, then ``parallel.shard_data``): a blocked side's
blocks and the head chunks of its own rows, a COO side's list of its stream
slice; and a copy of the tables.  Every kernel runs on the rank's part
unchanged, with ``num_l = rows // S`` and rank-local ``src``; the
collectives sit where the JAX solver's are (jax_solver.py:1224-1395): per
cross half-solve one all-gather of the other side's cache rows for the
stream (blocked tail, head chunks and a COO list read it), the Grams' and
the gradient's all-reduces and the carry's cross-order propagation outside
CG, and inside each CG iteration one all-reduce of Hv's table-space
output, into which the head rows' partial sums are added first.  A COO
side's order on a rank is its entries of the rank's rows in stream order:
the u side's stream slice, the v side's entries of the rank's items
(``parallel.shard_data``), so that its sums are the one-process sums row
for row.  On a 2-D ``data x model`` mesh the tables of
at least ``model_min_rows`` rows (padded to ``d_multiple``) are row-sharded
on the model axis: a half-solve gathers its table once over the model
group and keeps its own rows of the new table; the caches' refresh, the
objective and the callers' ``full_params`` gather the tables they read.

Each solve's CG runs the reference's device-resident loop (its
``lax.while_loop``): the recurrence after each Hv is one kernel
(``sparse_ops.cg_step``, csrc/cg_ops.cu) whose stop flag stays on the
card; on one process on the card each table's solve replays a CUDA graph
of ``cg_group`` iterations (``cg_graph``) and the host reads the flag once
a replay; under a mesh, one eager iteration per host read.

The state is a dict of tensors, as in the JAX package: ``params`` ({f12:
{"W", "H"}}), the caches ``P``/``Q`` ({f12: (rows, k)}), the side sums
``a``/``b``, and the residual carried in each side's order, ``yt_u``/
``yt_v``: a blocked side's slot order ((n_blocks, MAXC)), on a two-tier
side also its head slots, ``yt_u_hd``/``yt_v_hd`` ((NCH, CHUNK)); a COO
side's order is the stream itself ((nnz,), the JAX solver's stream-order
``yt``: the same floats).  Functions return new dicts and never modify a
state they were given.
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
    coo_list,
    feature_major,
    head_chunk_table,
    make_blocked_layout,
    row_runs,
)
from ..ops.sparse_ops import (
    acc_dtype,
    cg_init,
    cg_read,
    cg_step,
    expand_rows_blocked,
    gather_blocked_rows,
    grad_cross_tbl,
    grad_self_tbl,
    head_hv,
    head_pq,
    head_row_payload,
    head_scatter,
    head_seg_sum,
    hv_self_tbl,
    pos_dot,
    pos_gap_blocked,
    pos_hv_blocked,
    pos_hv_coo,
    pos_hv_tbl,
    pos_scatter,
    pos_scatter_blocked,
    pos_scatter_pair,
    pos_scatter_sq,
    pos_seg_sum,
    project,
    scatter,
    seg_sum_blocked,
    storage_scale,
)
from ..parallel.mesh import model_sharded
from ..utils.device import resolve_device
from ..utils.profiling import span
from .cg_graph import CgGraphs
from .params import HyperParams

Tensor = torch.Tensor

# the JAX package's default for the blocked layout's skew guard
# (OCFFM_BLK_PAD_RATIO)
_PAD_RATIO = 2.0
# largest field dim whose solves run the fused table-space passes (the JAX
# package's OCFFM_FUSED_TBL_D default); a wider non-identity field projects
# and scatters around the blocked passes
FUSED_TBL_D = 4096
# CG iterations per host read of the stop flag (on the card one CUDA graph
# replay): 1, since on the H100 no larger group ran any main path's epoch
# faster (chip_smoke.py cg-bench groups:); the tests set others
CG_GROUP = 1


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
    # per field: non-identity with D <= FUSED_TBL_D on a blocked side (JAX
    # _fused_field and _fused_tbl_side) — its solves run the fused table
    # passes; every non-identity field has its feature-major list in
    # data["xf_u"/"xf_v"]
    fused_u: Tuple[bool, ...] = ()
    fused_v: Tuple[bool, ...] = ()
    # rows per block of each side's blocked layout, 0 on a COO side
    blocked_bm_u: int = 0
    blocked_bm_v: int = 0
    # ranks of the data mesh the stream and both layouts are laid out for
    # (shard-aligned), 1 for one device
    blocked_shards: int = 1
    # block-table row dims rounded up to this multiple (the model axis of a
    # 2-D mesh divides them)
    d_multiple: int = 1

    def pad_d(self, d: int) -> int:
        """Padded table row dim (jax_solver.py ProblemMeta.pad_d).  Pad rows
        are never indexed by any feature, are zero at init and receive zero
        gradient and Hv, so they stay exactly zero."""
        mult = max(1, self.d_multiple)
        return -(-d // mult) * mult


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
                     blocked_bm: int = 256, head_chunk: int = 512,
                     device: torch.device | str = "cuda",
                     blocked_shards: int = 1, d_multiple: int = 1,
                     ) -> Tuple[ProblemMeta, Dict[str, Any]]:
    """Assemble the device tensor dict + static meta from host padded views
    (jax_solver.make_device_data, restricted to the keys the port uses).
    Builds the blocked layout of the positive stream for each segment side
    and checks the contiguous-run property of each.  A side without one
    (``blocked_bm=0``, or a side the builder rejects: rows not a multiple of
    ``blocked_bm``, or skew beyond the pad budget even with the head tier)
    takes the plain COO positive passes, as the JAX package's does
    (``blocked_bm_u`` / ``blocked_bm_v`` 0): its order is the stream itself
    (``blk_*_src``/``inv`` the identity, ``blk_*_w`` = ``pos_w``,
    ``blk_*_take`` and ``blk_*_seg`` the other side's and its own ids, 0 at
    the pads), and it gets its destination-major list of the stream
    (``coo_u``/``coo_v``, ``layout.coo_list``: pads dropped, power rows cut
    into chunks), built once.  For each non-identity field it builds the
    feature-major list of its X (``xf_u``/``xf_v``, None for an identity
    field) with X^2's values beside X's: the static
    X^T side of the fused table kernels (in place of the JAX package's
    transposed (p, rows) copies), of the general scatter and of the Jacobi
    diagonal, and the X^T kernel's plan beside them.  Building it rejects
    ids outside the field (ghost ids).  A fused field also gets its
    per-feature sums of squared values (``colsq_u``/``colsq_v``).  Each
    side's blocked layout also gets each row's run of slots
    (``blk_*_runs``, ``row_runs``), which the gradient scatter and the
    cross Hv kernels (B2, B1, B4) read in place of a search.

    A popularity-skewed side takes the two-tier layout: its tail is the
    blocked layout above with the power rows' entries dropped, its head
    ``(NCH, head_chunk)`` slots of those rows (``head_chunk``: the JAX
    package's ``OCFFM_HEAD_CHUNK``, same default; 0 turns the split off).
    Such a side gets the JAX package's head keys ``blk_*_hd_take/src/row/
    loc/w``, the head cross-order map ``blk_*_hd_from_*``, and for each
    fused field the head rows' field data ``xh_*`` ((idx, val), else None);
    and the port's own: the head rows ``blk_*_hd_rows``, their chunk table
    ``blk_*_hd_tab`` (``layout.head_chunk_table``) and the feature-major
    lists of ``xh_*`` (``xhf_*``).  The tensors go to the card unless
    ``device`` asks for the CPU.

    ``blocked_shards`` = S > 1: the full data of an S-rank data mesh, which
    ``parallel.mesh.shard_data`` cuts into each rank's part (the JAX
    package's shard-aligned layout, jax_solver.py:160-219).  The stream
    must be shard-aligned (``pad_labels(shard_rows=u.m // S)``); the u
    layout's ``blk_u_src`` is then local to its rank's stream slice, and a
    side takes the blocked layout only where ``blocked_bm`` divides its
    rows per rank, so that blocks nest in ranks (a head tier's chunk count
    padded to lcm(8, S)); as in the JAX package, a u side without one
    leaves both sides COO, on the shard-aligned stream.

    ``d_multiple`` > 1 rounds every block table's row dim up to that
    multiple (``ProblemMeta.pad_d``): ``reg`` (padded with 1.0) and
    ``colsq`` (with 0.0) take the padded lengths and the feature lists the
    padded ``D``, so that the tables divide a model axis."""
    device = resolve_device(device)
    pads = np.asarray(y.w) == 0
    blk_u = blk_v = None
    S = int(blocked_shards)
    mult = max(1, int(d_multiple))

    def pad_d(d: int) -> int:
        return -(-d // mult) * mult

    if S > 1:
        _check_shard_aligned(y, u.m, S)
        blk_u, blk_v = _sharded_layouts(u, v, y, blocked_bm, head_chunk,
                                        pads, S)
    elif blocked_bm:
        blk_u = make_blocked_layout(y.u, y.v, u.m, blocked_bm,
                                    max_pad_ratio=_PAD_RATIO, drop=pads,
                                    head_chunk=head_chunk)
        blk_v = make_blocked_layout(y.v, y.u, v.m, blocked_bm,
                                    max_pad_ratio=_PAD_RATIO, drop=pads,
                                    head_chunk=head_chunk)
    for b in (blk_u, blk_v):
        if b is not None:
            check_own_runs(b["own"], blocked_bm)

    ident_u, ident_v = _ident_flags(u), _ident_flags(v)

    def fused(pf: PaddedFields, ident, blk):
        # a fused pass reads its side's blocked stream
        return tuple(blk is not None and not i and pad_d(d) <= FUSED_TBL_D
                     for i, d in zip(ident, pf.Ds))

    meta = ProblemMeta(
        layout=layout, hp=hp, m=u.m, n=v.m, m_true=u.m_true, n_true=v.m_true,
        dtype=dtype, ident_u=ident_u, ident_v=ident_v,
        fused_u=fused(u, ident_u, blk_u), fused_v=fused(v, ident_v, blk_v),
        blocked_bm_u=blocked_bm if blk_u is not None else 0,
        blocked_bm_v=blocked_bm if blk_v is not None else 0,
        blocked_shards=S, d_multiple=mult)

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt or x.dtype)

    def regs(pf: PaddedFields):
        # pad value 1.0: pad table rows are exactly zero, so any finite
        # weight adds nothing (jax_solver.py regs)
        if hp.freq:
            return tuple(t(np.pad(np.asarray(fr), (0, pad_d(len(fr))
                                                  - len(fr)),
                                  constant_values=1.0), dtype)
                         for fr in pf.freq)
        return tuple(torch.ones(pad_d(d), dtype=dtype, device=device)
                     for d in pf.Ds)

    def xf(pf: PaddedFields, flags, rows=None):
        # ``rows``: the lists of those rows' field data only (the head rows)
        out = []
        for fi, on in enumerate(flags):
            if not on:
                out.append(None)
                continue
            idx, val = pf.idx[fi], pf.val[fi]
            if rows is not None:
                idx, val = idx[rows], val[rows]
            out.append(feature_list(idx, val, pad_d(pf.Ds[fi]), dtype,
                                    device))
        return tuple(out)

    def colsq(pf: PaddedFields, flags):
        # per-feature sum of squared values ((X^2)^T 1) of a fused field,
        # the omega term of its table-space Jacobi diagonal (jax_solver.py
        # colsq): float64 sums, one cast to storage
        out = []
        for fi, on in enumerate(flags):
            if not on:
                out.append(None)
                continue
            a = np.zeros(pad_d(pf.Ds[fi]), np.float64)
            np.add.at(a, np.asarray(pf.idx[fi]).ravel(),
                      np.asarray(pf.val[fi], np.float64).ravel() ** 2)
            out.append(t(a, dtype))
        return tuple(out)

    data: Dict[str, Any] = dict(
        xu_idx=tuple(t(a) for a in u.idx),
        xu_val=tuple(t(a, dtype) for a in u.val),
        xv_idx=tuple(t(a) for a in v.idx),
        xv_val=tuple(t(a, dtype) for a in v.val),
        xf_u=xf(u, [not i for i in ident_u]),
        xf_v=xf(v, [not i for i in ident_v]),
        colsq_u=colsq(u, meta.fused_u), colsq_v=colsq(v, meta.fused_v),
        pos_u=t(y.u), pos_v=t(y.v), pos_w=t(y.w, dtype),
        cnt_u=t(y.count_u, dtype), cnt_v=t(y.count_v, dtype),
        reg_u=regs(u), reg_v=regs(v),
    )
    # each side's order: its blocked layout's slots, or the stream itself
    nnz = int(y.w.shape[0])
    ident = np.arange(nnz, dtype=np.int32)
    order = {}
    for s, b, seg, take, rows, rows_o in (("u", blk_u, y.u, y.v, u.m, v.m),
                                          ("v", blk_v, y.v, y.u, v.m, u.m)):
        pre = f"blk_{s}_"
        if b is not None:
            # a shard-aligned layout's ``src`` is local to its rank's
            # stream slice: the maps read the stream positions
            order[s] = (b.get("src_abs", b["src"]), b["inv"],
                        b.get("hd_src"))
            continue
        order[s] = (ident, ident, None)
        data[pre + "src"] = data[pre + "inv"] = t(ident)
        data[pre + "w"] = data["pos_w"]
        data[pre + "take"] = t(np.where(pads, 0, take).astype(np.int32))
        data[pre + "seg"] = t(np.where(pads, 0, seg).astype(np.int32))
        lst = coo_list(seg, take, ~pads, rows, rows_o)
        # the weights in list order, read there by the COO passes (static:
        # permuted once)
        data["coo_" + s] = FeatureMajor(
            row=t(lst.row), val=t(y.w[lst.pos], dtype),
            chunk_ptr=t(lst.chunk_ptr), feat_ptr=t(lst.feat_ptr),
            n_rows=lst.n_rows, combine=t(lst.combine),
            chunk_dst=t(lst.chunk_dst), slot_feat=t(lst.slot_feat),
            pos=t(lst.pos))
    for pre, b in (("blk_u_", blk_u), ("blk_v_", blk_v)):
        if b is None:
            continue
        data[pre + "take"] = t(b["take"])
        data[pre + "src"] = t(b["src"])
        data[pre + "own"] = t(b["own"])
        data[pre + "runs"] = t(row_runs(b["own"], blocked_bm))
        # pre-permuted pad-mask weights, exactly 0 at structural pad slots:
        # also the slot-order pad mask of the residual carry
        data[pre + "w"] = t(y.w[b.get("src_abs", b["src"])]
                            * (b["own"] < b["block_rows"]), dtype)
        data[pre + "inv"] = t(b["inv"])
        if "hd_row" in b:
            # the head tier: chunked slots of the power rows' entries
            for key in ("hd_take", "hd_src", "hd_row", "hd_loc"):
                data[pre + key] = t(b[key])
            data[pre + "hd_w"] = t(y.w[b["hd_src"]] * b["hd_valid"], dtype)
            data[pre + "hd_rows"] = t(b["hd_rows"])
            data[pre + "hd_tab"] = t(head_chunk_table(
                b["hd_loc"], b["hd_valid"], len(b["hd_rows"])))
    for s, pf, b, flags in (("u", u, blk_u, meta.fused_u),
                            ("v", v, blk_v, meta.fused_v)):
        # the head rows' field data of each fused field, row-major for
        # their projection (B8) and feature-major for their X^T
        if b is None or "hd_rows" not in b:
            continue
        rows = b["hd_rows"]
        data["xh_" + s] = tuple(
            (t(pf.idx[fi][rows]), t(pf.val[fi][rows], dtype)) if on
            else None for fi, on in enumerate(flags))
        data["xhf_" + s] = xf(pf, flags, rows)
    # cross-order maps of the residual carry: for each slot of one side's
    # order, the flat index of the same entry in the other side's.  A
    # two-tier side's ``inv`` maps into its concatenated (tail, head) slot
    # space, and each tier of the receiving side gets its map; a COO side's
    # order is the stream, its ``src`` and ``inv`` the identity.
    for s, o in (("u", "v"), ("v", "u")):
        src, _, hd_src = order[s]
        inv_o = order[o][1]
        data[f"blk_{s}_from_{o}"] = t(inv_o[src])
        if hd_src is not None:
            data[f"blk_{s}_hd_from_{o}"] = t(inv_o[hd_src])
    return meta, data


def _check_shard_aligned(y: PaddedLabels, m: int, S: int) -> None:
    """Every entry of rank r's stream slice belongs to one of its users (the
    slices of ``pad_labels(shard_rows=m // S)``)."""
    nnz = int(y.w.shape[0])
    rank = np.arange(nnz) // max(1, nnz // S)
    if nnz % S or m % S or np.any(np.asarray(y.u) // (m // S) != rank):
        raise ValueError(
            f"the stream is not shard-aligned for {S} ranks: build the "
            f"labels with pad_labels(shard_rows={m // S})")


def _sharded_layouts(u: PaddedFields, v: PaddedFields, y: PaddedLabels,
                     blocked_bm: int, head_chunk: int, pads, S: int):
    """Both sides' blocked layouts for an S-rank data mesh, where they
    apply (jax_solver.py:164-199): the u side's over the shard-aligned
    stream with rank-local ``src`` (``shard_rows``), the v side's flat, its
    blocks nesting in ranks; a head tier's chunk count a multiple of
    lcm(8, S).  No u layout leaves both sides COO, as the JAX package's
    ``blocked_shards`` falls back to 1 there; a v side without one is
    COO."""
    if not blocked_bm or u.m % (S * blocked_bm):
        return None, None
    nch = 8 * S // math.gcd(8, S)
    blk_u = make_blocked_layout(y.u, y.v, u.m, blocked_bm,
                                max_pad_ratio=_PAD_RATIO,
                                shard_rows=u.m // S, drop=pads,
                                head_chunk=head_chunk, nch_multiple=nch)
    if blk_u is None or v.m % (S * blocked_bm):
        return blk_u, None
    blk_v = make_blocked_layout(y.v, y.u, v.m, blocked_bm,
                                max_pad_ratio=_PAD_RATIO, drop=pads,
                                head_chunk=head_chunk, nch_multiple=nch)
    return blk_u, blk_v


def _rows_to(T: Tensor, rows: int) -> Tensor:
    """``T`` cut or zero-padded to ``rows`` rows (an identity field's table
    against its row count: the rows past either are zero)."""
    if T.shape[0] == rows:
        return T
    return torch.nn.functional.pad(T, (0, 0, 0, rows - T.shape[0]))


def feature_list(idx, val, D: int, dtype: torch.dtype,
                 device: torch.device | str) -> FeatureMajor:
    """The feature-major list of a field's padded (idx, val) rows as device
    tensors (``layout.feature_major``), with X^2's values beside X's,
    squared at storage dtype: the rounding of both JAX forms, _scat_sq's
    v1 * v1 and the fused kernels' _xoh_block(square=True)
    (jax_solver.py:1916, sparse_ops.py:1094), which square the stored value
    and round the square to storage.  Building it rejects ids outside the
    field (ghost ids)."""
    fm = feature_major(np.asarray(idx), np.asarray(val), D)

    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(device=device, dtype=dt or x.dtype)

    vals = t(fm.val, dtype)
    return FeatureMajor(
        row=t(fm.row), val=vals, chunk_ptr=t(fm.chunk_ptr),
        feat_ptr=t(fm.feat_ptr), n_rows=fm.n_rows, val_sq=vals * vals,
        combine=t(fm.combine), chunk_dst=t(fm.chunk_dst),
        slot_feat=t(fm.slot_feat))


class FFMSolver:
    """Solver bound to one problem instance.

    Usage:
        solver = FFMSolver(meta, data)
        state = solver.init(torch.Generator(device).manual_seed(0))
        state = solver.epoch(state)
    """

    def __init__(self, meta: ProblemMeta, data: Dict[str, Any],
                 mesh=None, model_min_rows: Optional[int] = None):
        S = meta.blocked_shards
        n_model = getattr(mesh, "n_model", 1)
        if mesh is not None and mesh.size == 1 and S == 1 and n_model == 1:
            mesh = None  # one rank: the single-device solver
        if mesh is not None and mesh.size != S:
            raise ValueError(
                f"a mesh of {mesh.size} data ranks runs the shard-aligned "
                f"data of its ranks: make_device_data(blocked_shards="
                f"{mesh.size}), then parallel.shard_data")
        if mesh is None and S > 1:
            raise ValueError("blocked_shards > 1 (the shard-aligned layout) "
                             "requires constructing FFMSolver with mesh=")
        hp = meta.hp
        # "auto" is plain CG, the reference's exact solver; Jacobi-PCG is
        # an opt-in (jax_solver.py:517-519)
        self.cg_precond = "none" if hp.cg_precond == "auto" else hp.cg_precond
        if self.cg_precond not in ("none", "jacobi"):
            raise ValueError(f"unknown cg_precond {hp.cg_precond!r}")
        self.meta = meta
        self.data = data
        self.blocks: List[BlockInfo] = meta.layout.all_blocks()
        self.device = data["pos_u"].device
        # under a data mesh: this rank's rows of each side (``m_l`` /
        # ``n_l`` from row ``lo_u`` / ``lo_v``); the data is its part
        # (parallel.shard_data), the tables are replicated, or on a 2-D
        # mesh those of at least ``model_min_rows`` rows row-sharded on
        # the model axis
        self.mesh = mesh
        self.model_min_rows = model_min_rows if n_model > 1 else None
        rank = mesh.rank if mesh is not None else 0
        self.m_l, self.n_l = meta.m // S, meta.n // S
        self.lo_u, self.lo_v = rank * self.m_l, rank * self.n_l
        if data["xu_idx"][0].shape[0] != self.m_l:
            raise ValueError(
                f"the data holds {data['xu_idx'][0].shape[0]} user rows, "
                f"not this rank's {self.m_l}: pass parallel.shard_data's "
                f"part of it")
        # two-tier head tiers: wherever a side's tail arrays are read, its
        # head entries' part is added (the tail layout dropped them)
        self.hd_u = "blk_u_hd_row" in data
        self.hd_v = "blk_v_hd_row" in data
        # the head slots' (1 - omega) w, the weights of the head Hv terms
        # and of the Jacobi diagonal's head payload (static)
        self._hd_wq = {s: storage_scale(data[f"blk_{s}_hd_w"],
                                        1.0 - hp.omega)
                       for s in ("u", "v") if f"blk_{s}_hd_w" in data}
        # the stream's ids for the residual refresh's pos_dot: users local
        # to this rank's rows (int32, as its kernel reads them)
        self._pos_ids = ((data["pos_u"] - self.lo_u).to(torch.int32),
                         data["pos_v"].to(torch.int32))
        # CG: ``cg_group`` iterations per host read of the stop flag (on the
        # card one CUDA graph replay of them); set ``cg_host_loop`` for one
        # eager iteration per host read instead, as a mesh always runs
        on_card = self.device.type == "cuda"
        self.cg_group = CG_GROUP
        self.cg_host_loop = False
        # host reads of the stop flag, graph replays, iterations run after
        # their solve's stop, graph captures and the host seconds they took,
        # since the solver was made
        self.cg_counts = dict(reads=0, replays=0, masked=0, captures=0,
                              capture_s=0.0)
        self._graphs = CgGraphs(self.device, counts=self.cg_counts) \
            if on_card else None

    # -- collectives (a data mesh; no-ops on one device) ----------------------

    def _allreduce(self, t: Tensor, site: str) -> Tensor:
        """Sum of a rank's partial over the mesh (table-space outputs,
        Grams, scalar sums)."""
        return t if self.mesh is None else self.mesh.all_reduce_sum(t, site)

    def _allreduce_many(self, ts, site: str):
        """``_allreduce`` of several tensors of one dtype in one call."""
        if self.mesh is None:
            return list(ts)
        flat = self.mesh.all_reduce_sum(
            torch.cat([t.reshape(-1) for t in ts]), site)
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    def _row_sums(self, parts, site: str):
        """Sums over a side's rows (k-vectors, k x k Grams, scalars), each
        part given at float64: summed over the mesh in one call, then
        rounded once to the storage dtype.  After an epoch a gradient is a
        small difference of such sums over the other side's rows and the
        positive sums: at float32 their rounding is up to 1e-4 of it, and
        a mesh, which splits each sum, would round otherwise than one
        process.  At float64 both round the same value."""
        return [t.to(self.meta.dtype)
                for t in self._allreduce_many(parts, site)]

    def _gather(self, t: Tensor, site: str) -> Tensor:
        """Every rank's rows of a row-sharded array, in row order."""
        return t if self.mesh is None else self.mesh.all_gather(t, site)

    # -- tables on a model axis (a 2-D mesh) ----------------------------------

    def _rows(self, b: BlockInfo, first: bool) -> int:
        """Padded row dim of the block's f1 or f2 table."""
        return self.meta.pad_d(b.d1 if first else b.d2)

    def _sharded(self, rows: int) -> bool:
        """A table of ``rows`` padded rows lies row-sharded on the model
        axis."""
        return model_sharded(rows, self.mesh, self.model_min_rows)

    def full_params(self, params, site: str = "read"):
        """The whole tables: each model-sharded one gathered over the model
        group (one all-gather per table), the others as they are."""
        out = {}
        for b in self.blocks:
            out[b.f12] = {}
            for key, first in (("W", True), ("H", False)):
                T = params[b.f12][key]
                dp = self._rows(b, first)
                if self._sharded(dp) and T.shape[0] != dp:
                    T = self.mesh.model_all_gather(T, site)
                out[b.f12][key] = T
        return out

    def table_specs(self):
        """{f12: {"W" | "H": (padded rows, row-sharded on the model axis?)}}
        of every block table (a sharded checkpoint's placements)."""
        return {b.f12: {key: (self._rows(b, first),
                              self._sharded(self._rows(b, first)))
                        for key, first in (("W", True), ("H", False))}
                for b in self.blocks}

    def _place_params(self, params):
        """Tables as a state holds them, on this rank's device: given whole
        (true or padded dims, zero pad rows appended) or as this rank's
        model rows; a model-sharded table cut to this rank's rows."""
        out = {}
        for b in self.blocks:
            out[b.f12] = {}
            for key, first in (("W", True), ("H", False)):
                T = torch.as_tensor(params[b.f12][key]).to(self.device)
                dp = self._rows(b, first)
                part = self._sharded(dp) and T.shape[0] == dp // (
                    self.mesh.n_model)
                if not part and T.shape[0] < dp:
                    T = torch.nn.functional.pad(T, (0, 0, 0, dp - T.shape[0]))
                if self._sharded(dp) and not part:
                    T = T[self.mesh.model_rows(dp)].contiguous()
                out[b.f12][key] = T
        return out

    def _with_table(self, state, b: BlockInfo, first: bool):
        """``state`` with the half-solve's table whole (gathered once over
        the model group when it is model-sharded)."""
        key = "W" if first else "H"
        T = state["params"][b.f12][key]
        dp = self._rows(b, first)
        if not self._sharded(dp) or T.shape[0] == dp:
            return state
        params = dict(state["params"])
        params[b.f12] = dict(params[b.f12])
        params[b.f12][key] = self.mesh.model_all_gather(T, "table")
        return dict(state, params=params)

    def _keep_rows(self, state, b: BlockInfo, first: bool):
        """``state`` with a model-sharded table cut back to this rank's
        rows (no collective: every rank holds the whole new table)."""
        key = "W" if first else "H"
        dp = self._rows(b, first)
        if not self._sharded(dp):
            return state
        params = dict(state["params"])
        params[b.f12] = dict(params[b.f12])
        params[b.f12][key] = params[b.f12][key][
            self.mesh.model_rows(dp)].contiguous()
        return dict(state, params=params)

    def _lo(self, u_side: bool) -> int:
        """This rank's first row of the u (True) / v (False) side."""
        return self.lo_u if u_side else self.lo_v

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
            return self.data["reg_u"][fl], self.m_l, self.meta.m_true
        return self.data["reg_v"][fl], self.n_l, self.meta.n_true

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
        rows are zero by invariant): under a mesh this rank's rows of it."""
        idx, val, xf = self._x(b, first)
        if xf is not None:
            return project(idx, val, T)
        _, rows, _ = self._side(b, first)
        if self.mesh is None:
            return _rows_to(T, rows)
        lo = self._lo(self._u_field(b, first)[0])
        out = T.new_zeros((rows, T.shape[1]))
        hi = min(lo + rows, T.shape[0])
        if hi > lo:
            out[: hi - lo] = T[lo:hi]
        return out

    def _ident_scat(self, b: BlockInfo, first: bool, Z: Tensor,
                    dim: int) -> Tensor:
        """X^T Z of an identity field: row d receives row d (under a mesh
        this rank's rows, at their place in the table, zero elsewhere).  The
        rows at and past the field's true row count are the data's pad
        rows, whose omega terms are not zero: a table padded past that
        count (``d_multiple``) keeps them out, as the JAX package's
        ``_scat`` masks them, so that its pad rows stay zero."""
        true = min(dim, b.d1 if first else b.d2)
        if self.mesh is None:
            return _rows_to(_rows_to(Z, true), dim)
        lo = self._lo(self._u_field(b, first)[0])
        out = Z.new_zeros((dim, Z.shape[1]))
        hi = min(lo + Z.shape[0], true)
        if hi > lo:
            out[lo:hi] = Z[: hi - lo]
        return out

    def _scat(self, b: BlockInfo, first: bool, Z: Tensor, dim: int,
              site: str = "grad") -> Tensor:
        """X_side^T @ Z at storage dtype: for an identity field row d
        receives row d; a wide feature field scatters through its
        feature-major list (pad rows carry val == 0 and are not in it, so
        nothing is masked).  A small-D field's solves scatter inside the
        fused table passes.  Under a mesh each rank scatters its rows and
        the partial tables are all-reduced (``site`` names the call)."""
        return self._allreduce(self._scat_part(b, first, Z, dim), site)

    def _scat_part(self, b: BlockInfo, first: bool, Z: Tensor, dim: int,
                   squared: bool = False) -> Tensor:
        """This rank's part of ``_scat`` (``_scat_sq`` with ``squared``)
        before the all-reduce."""
        _, _, xf = self._x(b, first)
        if xf is not None:
            return scatter(xf, Z, squared=squared)
        return self._ident_scat(b, first, Z, dim)

    def _scat_sq(self, b: BlockInfo, first: bool, Z: Tensor,
                 dim: int) -> Tensor:
        """(X_side^2)^T @ Z at storage dtype, the squared-feature scatter of
        the Jacobi diagonal (jax_solver.py _scat_sq): for an identity field
        X^2 == X, the slice; a wide field scatters through its list's
        squared values (all-reduced under a mesh, as ``_scat``)."""
        return self._allreduce(self._scat_part(b, first, Z, dim, True),
                               "diag")

    def _side_colsq(self, b: BlockInfo, first: bool) -> Tensor:
        """Per-feature sum of squared values of a fused field, (D,): the
        (X^2)^T of a constant row is colsq times that row (the omega term of
        the table-space Jacobi diagonal)."""
        u_side, fl = self._u_field(b, first)
        return self.data["colsq_u" if u_side else "colsq_v"][fl]

    def _side_xh(self, b: BlockInfo, first: bool):
        """(xh_idx, xh_val, feature-major list) of the head rows' data of
        the block side's field, or None (no head tier on that side, or a
        field off the fused passes)."""
        u_side, fl = self._u_field(b, first)
        s = "u" if u_side else "v"
        xh = self.data.get("xh_" + s)
        if xh is None or xh[fl] is None:
            return None
        return (*xh[fl], self.data["xhf_" + s][fl])

    def _hd_side(self, u_side: bool) -> bool:
        """Head tier present on the u (True) / v (False) segment side."""
        return self.hd_u if u_side else self.hd_v

    def _hd_coeff(self, state, u_side: bool) -> Tensor:
        """Gradient coefficients on the head tier's slots (NCH, CHUNK),
        elementwise on the carried head residual (pad slots weigh 0)."""
        s = "u" if u_side else "v"
        return (self._pos_coeff(state[f"yt_{s}_hd"])
                * self.data[f"blk_{s}_hd_w"])

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
        reproduced; only the law is the same.  The draws are of the true
        dims, so ``d_multiple`` pads them with zero rows without changing
        them, and every rank of a mesh draws the same tables."""
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
        from the tables: used at init and after loading a checkpoint.  The
        tables may come whole (true or padded dims) or as this rank's model
        rows; the state holds them as ``_place_params`` places them."""
        params = self._place_params(state["params"])
        whole = self.full_params(params, "refresh")
        P, Q = {}, {}
        for b in self.blocks:
            P[b.f12] = self._proj(b, True, whole[b.f12]["W"])
            Q[b.f12] = self._proj(b, False, whole[b.f12]["H"])
        a, b_vec = self._side_sums(P, Q)
        yt = self._pos_scores(P, Q, a, b_vec) - 1.0
        d = self.data
        out = dict(params=params, P=P, Q=Q, a=a, b=b_vec)
        if self.mesh is not None:
            # a rank's stream slice holds its u slots' entries (tail and
            # head); the v carry reads the ranks' u carries through the
            # cross-order maps
            out["yt_u"] = yt[d["blk_u_src"].long()] * d["blk_u_w"]
            flat = out["yt_u"].reshape(-1)
            if self.hd_u:
                out["yt_u_hd"] = (yt[d["blk_u_hd_src"].long()]
                                  * d["blk_u_hd_w"])
                flat = torch.cat([flat, out["yt_u_hd"].reshape(-1)])
            flat = self._gather(flat, "refresh")
            out["yt_v"] = flat[d["blk_v_from_u"].long()] * d["blk_v_w"]
            if self.hd_v:
                out["yt_v_hd"] = (flat[d["blk_v_hd_from_u"].long()]
                                  * d["blk_v_hd_w"])
            return out
        for s in ("u", "v"):
            out["yt_" + s] = yt[d[f"blk_{s}_src"].long()] * d[f"blk_{s}_w"]
            if self._hd_side(s == "u"):
                out[f"yt_{s}_hd"] = (yt[d[f"blk_{s}_hd_src"].long()]
                                     * d[f"blk_{s}_hd_w"])
        return out

    def yt_stream(self, state) -> Tensor:
        """The positive residual in stream order, pad-masked (diagnostics and
        the objective; the epoch works on the slot-order carry).  A two-tier
        u side's ``inv`` maps into its concatenated (tail, head) slots."""
        d = self.data
        flat = state["yt_u"].reshape(-1)  # under a mesh: this rank's slots
        if self.hd_u:
            flat = torch.cat([flat, state["yt_u_hd"].reshape(-1)])
        return flat[d["blk_u_inv"].long()] * d["pos_w"]

    def _side_sums(self, P, Q) -> Tuple[Tensor, Tensor]:
        """a_i / b_j self-interaction sums (calc_side, ffm.cpp:360-373)."""
        meta = self.meta
        a = torch.zeros(self.m_l, dtype=meta.dtype, device=self.device)
        b_vec = torch.zeros(self.n_l, dtype=meta.dtype, device=self.device)
        for blk in meta.layout.user_self_blocks():
            a = a + (P[blk.f12] * Q[blk.f12]).sum(dim=1)
        for blk in meta.layout.item_self_blocks():
            b_vec = b_vec + (P[blk.f12] * Q[blk.f12]).sum(dim=1)
        return a, b_vec

    def _pos_scores(self, P, Q, a, b_vec) -> Tensor:
        """yhat at every positive pair (init_y_tilde, ffm.cpp:388-403).
        Under a mesh: at this rank's stream slice, whose users are its own
        rows; the items' side sums and caches are gathered."""
        u, v = self._pos_ids
        cross = self.meta.layout.cross_blocks()
        if self.mesh is not None:
            b_vec = self._gather(b_vec, "refresh")
            Q = {blk.f12: self._gather(Q[blk.f12], "refresh")
                 for blk in cross}
        z = (a[u.long().clamp(max=a.shape[0] - 1)]
             + b_vec[v.long().clamp(max=b_vec.shape[0] - 1)])
        for blk in cross:
            z = z + pos_dot(P[blk.f12], u, Q[blk.f12], v)
        return z

    def _cache_sasb(self, P, Q) -> Tuple[Tensor, Tensor]:
        """sa_i = sum_j cross(i, j), sb_j = sum_i cross(i, j) (cache_sasb,
        ffm.cpp:514-535); only self-block gradients read them."""
        meta = self.meta
        sa = torch.zeros(self.m_l, dtype=meta.dtype, device=self.device)
        sb = torch.zeros(self.n_l, dtype=meta.dtype, device=self.device)
        cross = meta.layout.cross_blocks()
        sums = self._row_sums(
            [X[blk.f12].double().sum(dim=0) for blk in cross for X in (Q, P)],
            "sums")
        for i, blk in enumerate(cross):
            Pb, Qb = P[blk.f12], Q[blk.f12]
            sa = sa + Pb @ sums[2 * i]
            sb = sb + Qb @ sums[2 * i + 1]
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
        """(key prefix, output rows, block rows) of a side's blocked layout
        (block rows 0 on a COO side: read them only where ``_coo`` is
        None); the output rows are this rank's under a mesh."""
        meta = self.meta
        if u_side:
            return "blk_u_", self.m_l, meta.blocked_bm_u
        return "blk_v_", self.n_l, meta.blocked_bm_v

    def _coo(self, u_side: bool) -> Optional[FeatureMajor]:
        """A COO side's destination-major list of the positive stream, or
        None on a blocked side."""
        return self.data.get("coo_u" if u_side else "coo_v")

    def _stream_ids(self, u_side: bool) -> Tuple[Tensor, Tensor]:
        """(own ids, other side's ids) of the entries of a COO side's order
        (the stream; under a mesh the rank's part of it: own ids local to
        the rank's rows, the other side's global), 0 at the pads."""
        pre = "blk_u_" if u_side else "blk_v_"
        return self.data[pre + "seg"], self.data[pre + "take"]

    def _grad_cross(self, state, b: BlockInfo, first: bool,
                    rows_pre: Tensor, with_diag_pos: bool = False,
                    rows_hd: Optional[Tensor] = None):
        """Gradient for one table of a cross block (gd_cross, ffm.cpp:630-703):
        omega part via k x k Grams, positive part by the scatter kernel over
        the pre-gathered stream; on a small-D feature field both go to table
        space in one fused pass, on a wide one the X^T stage scatters them.
        A COO side's positive part sums through its list of the stream
        (``pos_scatter``, under Jacobi ``pos_scatter_pair``:
        jax_solver.py:1578-1586, 1620-1627).

        ``with_diag_pos`` (Jacobi): returns (G, term) where term is the
        Hessian diagonal's positive part from the same read of the stream:
        on a fused field ("tbl", the complete table-space scatter term at
        the float32 floor), else the row-space posq[r] = sum_t (1-w) w_t
        rows_t^2 that _diag_H scatters through X^2.

        ``rows_hd``: the solve's head stream on a two-tier side, whose
        entries' part is added in table space on a fused field
        (``_hd_tbl``), else in row space (``head_scatter``), before the
        all-reduce of a mesh.  On a COO side ``rows_pre`` is the other
        side's gathered cache under a mesh (else None: the state's)."""
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
        cross = meta.layout.cross_blocks()
        # the k-vectors and k x k Grams over the other side's rows: one
        # all-reduce of their partials under a mesh
        B1d = B1.double()
        red = self._row_sums(
            [B1d.sum(dim=0), B1d.T @ oth_vec.double()]
            + [oth_c[blk.f12].double().T @ B1d for blk in cross]
            + ([(B1d * B1d).sum(dim=0)]
               if with_diag_pos and self._fused(b, first) else []), "gram")
        oQ, bQ = red[0], red[1]
        gram_T = torch.zeros((num, hp.k), dtype=meta.dtype, device=self.device)
        for i, blk in enumerate(cross):
            gram_T = gram_T + own_c[blk.f12] @ red[2 + i]
        dense = hp.omega * ((side - hp.r)[:, None] * oQ[None, :]
                            + bQ[None, :] + gram_T)
        _, _, xf = self._x(b, first)
        # the diagonal's weights are static: (1 - omega) times the slot
        # order's pad mask, scaled inside the pass
        diag_w = dict(w_blk=d[pre + "w"], wq_scale=1.0 - hp.omega) \
            if with_diag_pos else {}
        if self._fused(b, first):
            res = grad_cross_tbl(xf, rows_pre, d[pre + "own"], c_blk, dense,
                                 bm, runs=d[pre + "runs"], **diag_w)
            Gt, Qt = res if with_diag_pos else (res, None)
            if rows_hd is not None:
                g_hd, q_hd = self._hd_tbl(state, b, first, rows_hd,
                                          with_diag_pos)
                Gt = Gt + g_hd
                if with_diag_pos:
                    Qt = Qt + q_hd
            if self.mesh is not None:
                if with_diag_pos:
                    Gt, Qt = self._allreduce_many([Gt, Qt], "grad")
                else:
                    Gt = self._allreduce(Gt, "grad")
            if not with_diag_pos:
                return self._tbl_grad(b, first, T, Gt)
            qtq_d = red[-1]  # (B1 * B1).sum(dim=0); pad rows are zero
            acc = acc_dtype(meta.dtype)
            tbl_d = (hp.omega * (self._side_colsq(b, first).to(acc)[:, None]
                                 * qtq_d.to(acc)[None, :]) + Qt.to(acc))
            return self._tbl_grad(b, first, T, Gt), ("tbl", tbl_d)
        coo = self._coo(first)
        Bs = B1 if rows_pre is None else rows_pre  # a COO side's rows
        if coo is None:
            res = pos_scatter_blocked(c_blk, rows_pre, d[pre + "own"], num,
                                      bm, runs=d[pre + "runs"], **diag_w)
        elif with_diag_pos:
            res = pos_scatter_pair(c_blk, Bs, coo, 1.0 - hp.omega)
        else:
            res = pos_scatter(c_blk, Bs, coo)
        zpos, posq = res if with_diag_pos else (res, None)
        if rows_hd is not None:
            hpre = pre + "hd_"
            res_h = head_scatter(
                self._hd_coeff(state, first), rows_hd, d[hpre + "tab"],
                d[hpre + "rows"], num,
                diag_w_hd=self._hd_wq["u" if first else "v"]
                if with_diag_pos else None)
            if with_diag_pos:
                zpos, posq = zpos + res_h[0], posq + res_h[1]
            else:
                zpos = zpos + res_h
        G = hp.lam * reg[:, None] * T + self._scat(
            b, first, dense + zpos, T.shape[0])
        return (G, posq) if with_diag_pos else G

    def _hd_tbl(self, state, b: BlockInfo, first: bool, rows_hd: Tensor,
                with_diag: bool = False):
        """The head entries' part of a fused cross gradient in table space
        (jax_solver.py ``hd_tbl``): each head row's chunk sums of c rows_t,
        scattered through X_head^T; with ``with_diag`` also the Jacobi
        diagonal's, the sums of (1-w) w rows_t^2 through X_head^2.  Returns
        (Gt term, Qt term or None), at storage dtype."""
        d = self.data
        pre = "blk_u_hd_" if first else "blk_v_hd_"
        _, _, xh = self._side_xh(b, first)
        dt = rows_hd.dtype
        # X_head^T through the head rows' list: the JAX head_tbl_scatter
        z_hd = head_row_payload(self._hd_coeff(state, first), rows_hd,
                                d[pre + "tab"]).to(dt)
        g = scatter(xh, z_hd)
        if not with_diag:
            return g, None
        q_hd = head_row_payload(self._hd_wq["u" if first else "v"],
                                rows_hd * rows_hd, d[pre + "tab"]).to(dt)
        return g, scatter(xh, q_hd, squared=True)

    def _grad_self(self, state, b: BlockInfo, first: bool, sa: Tensor,
                   sb: Tensor, want_diag: bool = False):
        """Gradient for one table of a self block (gd_side, ffm.cpp:537-592):

            z_i = w [ n (a_i - r) + sum(b) + sa_i ] + sum_{j in pos_i} c_ij
            G   = lam reg T + X1^T diag(z) Q1

        The per-row positive sums run over the slot-order carry of the
        block's side (on a COO side through its list of the stream,
        ``pos_seg_sum``: jax_solver.py:1213-1217); on a small-D feature
        field they, the dense term and the X^T scatter are one fused pass.
        ``want_diag`` (Jacobi): returns (G, term), term the fused pass's
        table-space diagonal ("tbl", (X^2)^T diag(dd) Q1^2) or None off the
        fused path (_diag_H then scatters its own)."""
        meta, d = self.meta, self.data
        hp = meta.hp
        T = state["params"][b.f12]["W" if first else "H"]
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        u_side = b.kind == "uu"
        if u_side:
            n_other, side, s_cache, other = (
                meta.n_true, state["a"], sa, state["b"])
        else:
            n_other, side, s_cache, other = (
                meta.m_true, state["b"], sb, state["a"])
        other_sum, = self._row_sums([other.double().sum()], "sums")
        pre, num, bm = self._blk(u_side)
        c_blk = self._pos_coeff(state["yt_u" if u_side else "yt_v"]) \
            * d[pre + "w"]
        zdense = hp.omega * (n_other * (side - hp.r) + other_sum + s_cache)
        # the head entries' per-row sums (absent from the tail slots): on a
        # fused field they ride zdense into the pass, else zpos
        z_hd = None
        if self._hd_side(u_side):
            z_hd = head_seg_sum(self._hd_coeff(state, u_side),
                                d[pre + "hd_tab"], d[pre + "hd_rows"], num)
        _, _, xf = self._x(b, first)
        if self._fused(b, first):
            if z_hd is not None:
                zdense = zdense + z_hd
            if not want_diag:
                return self._tbl_grad(b, first, T, self._allreduce(
                    grad_self_tbl(xf, Q1, zdense, d[pre + "own"], c_blk, bm,
                                  runs=d[pre + "runs"]), "grad"))
            Gt, Dq = self._allreduce_many(grad_self_tbl(
                xf, Q1, zdense, d[pre + "own"], c_blk, bm,
                dd=self._self_dd(b), runs=d[pre + "runs"]), "grad")
            return (self._tbl_grad(b, first, T, Gt),
                    ("tbl", Dq.to(acc_dtype(meta.dtype))))
        coo = self._coo(u_side)
        zpos = (seg_sum_blocked(c_blk, d[pre + "own"], num, bm)
                if coo is None else pos_seg_sum(c_blk, coo))
        if z_hd is not None:
            zpos = zpos + z_hd
        z = zdense + zpos
        reg, _, _ = self._side(b, first)
        G = hp.lam * reg[:, None] * T + self._scat(
            b, first, z[:, None] * Q1, T.shape[0])
        return (G, None) if want_diag else G

    def _self_dd(self, b: BlockInfo) -> Tensor:
        """d_i = (1-w)|pos_i| + w n of a self block's side, at storage
        dtype: the per-row weight of its Hv and of its Jacobi diagonal."""
        meta, d, hp = self.meta, self.data, self.meta.hp
        if b.kind == "uu":
            return (1.0 - hp.omega) * d["cnt_u"] + hp.omega * meta.n_true
        return (1.0 - hp.omega) * d["cnt_v"] + hp.omega * meta.m_true

    @staticmethod
    def _hv_closure(key, inputs: Dict[str, Tensor], make):
        """``make(inputs)``, the Hv closure of one solve, which reads the
        solve's own tensors only through ``inputs``; it carries its key,
        its inputs and ``make``, from which the CUDA graph path builds the
        same closure on buffers that stay put (``cg_graph.CgGraphs``)."""
        hv = make(inputs)
        hv.cg_key, hv.cg_inputs, hv.cg_make = key, inputs, make
        return hv

    def _hv_cross(self, state, b: BlockInfo, first: bool, rows_pre: Tensor,
                  rows_hd: Optional[Tensor] = None):
        """Hv closure for a cross-block table (hs_cross, ffm.cpp:706-742):
        one kernel pass per call, the omega Q1^T Q1 term fused into it (and
        on a small-D feature field the projection and the X^T scatter too;
        a wide field projects with B8 before it and scatters after it).
        With ``rows_hd`` (a two-tier side's head stream) the head entries'
        part is added: in table space on a fused field (``_hd_hv_tbl``),
        else in row space before the scatter (``head_hv``).  A COO side
        runs the JAX package's two-call form (jax_solver.py:1894-1903),
        ``pos_dot`` times w, then ``pos_scatter`` of (1-w) pq, as one pass
        over its list (``pos_hv_coo``: the same function and roundings), the
        omega term a matmul beside it."""
        meta, d = self.meta, self.data
        hp = meta.hp
        reg, _, _ = self._side(b, first)
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        coo = self._coo(first)
        key = ("uv", b.f12, first)
        if coo is not None:
            B1d = B1.double()
            qtq, = self._row_sums([B1d.T @ B1d], "gram")  # pad rows are zero
            Bs = B1 if rows_pre is None else rows_pre

            def make_coo(x):
                def hv_coo(V: Tensor) -> Tensor:
                    phi = self._proj(b, first, V)
                    zp = pos_hv_coo(phi, x["B"], coo, 1.0 - hp.omega)
                    return hp.lam * reg[:, None] * V + self._scat(
                        b, first, hp.omega * (phi @ x["qtq"]) + zp, dim,
                        "hv")
                return hv_coo

            return self._hv_closure(key, dict(B=Bs, qtq=qtq), make_coo)
        pre, num, bm = self._blk(first)
        B1d = B1.double()
        dmat = (hp.omega * self._row_sums([B1d.T @ B1d], "gram")[0]
                ).to(meta.dtype)
        own, w_blk, runs = d[pre + "own"], d[pre + "w"], d[pre + "runs"]
        w_scale = 1.0 - hp.omega
        idx, val, xf = self._x(b, first)
        fused = self._fused(b, first)

        hpre = pre + "hd_"
        wq_hd = self._hd_wq.get("u" if first else "v")
        inputs = dict(rows_pre=rows_pre, dmat=dmat)
        if rows_hd is not None:
            inputs["rows_hd"] = rows_hd

        def make(x):
            rows, dense, rows_h = x["rows_pre"], x["dmat"], x.get("rows_hd")

            def hv(V: Tensor) -> Tensor:
                if fused:
                    G = pos_hv_tbl(V, idx, val, xf, rows, own, w_blk, dense,
                                   bm, w_scale, runs=runs)
                    if rows_h is not None:
                        G = G + self._hd_hv_tbl(b, first, V, rows_h)
                    G = self._allreduce(G, "hv")
                    return hp.lam * reg[:, None] * V + G.to(V.dtype)
                phi = self._proj(b, first, V)
                zp = pos_hv_blocked(phi, rows, own, w_blk, dense, num, bm,
                                    w_scale, runs=runs)
                if rows_h is not None:
                    zp = zp + head_hv(phi, rows_h, wq_hd, d[hpre + "row"],
                                      d[hpre + "tab"], d[hpre + "rows"], num)
                return hp.lam * reg[:, None] * V + self._scat(b, first, zp,
                                                              dim, "hv")
            return hv

        return self._hv_closure(key, inputs, make)

    def _hd_hv_tbl(self, b: BlockInfo, first: bool, V: Tensor,
                   rows_hd: Tensor) -> Tensor:
        """The head entries' part of a fused cross Hv in table space, at
        storage dtype (jax_solver.py:1831-1845): phi of the head rows only
        (B8), each entry's w_scale w <phi, row_t> row_t summed per head
        row, scattered through X_head^T.  The dense omega term is the tail
        pass's."""
        d = self.data
        pre = "blk_u_hd_" if first else "blk_v_hd_"
        xh_idx, xh_val, xh = self._side_xh(b, first)
        phi_hd = project(xh_idx, xh_val, V)  # the JAX head_project
        cq = head_pq(phi_hd.index_select(0, d[pre + "loc"]), rows_hd) \
            * self._hd_wq["u" if first else "v"]
        z_hd = head_row_payload(cq, rows_hd, d[pre + "tab"])
        return scatter(xh, z_hd.to(phi_hd.dtype))  # the JAX head_tbl_scatter

    def _hv_self(self, state, b: BlockInfo, first: bool):
        """Hv closure for a self-block table (hs_side, ffm.cpp:594-628):
        d_i = (1-w)|pos_i| + w n;  Hv = lam reg V + X1^T diag(d <Q1, X1 V>)
        Q1 — one fused table pass per call on a small-D feature field, B8
        and the X^T stage on a wide one."""
        hp = self.meta.hp
        reg, _, _ = self._side(b, first)
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        idx, val, xf = self._x(b, first)
        fused = self._fused(b, first)

        def make(x):
            Q1, dd = x["Q1"], x["dd"]

            def hv(V: Tensor) -> Tensor:
                if fused:
                    G = self._allreduce(hv_self_tbl(V, idx, val, xf, Q1, dd),
                                        "hv")
                    return hp.lam * reg[:, None] * V + G.to(V.dtype)
                s = dd * (Q1 * self._proj(b, first, V)).sum(dim=1)
                return hp.lam * reg[:, None] * V + self._scat(
                    b, first, s[:, None] * Q1, dim, "hv")
            return hv

        return self._hv_closure((b.kind, b.f12, first),
                                dict(Q1=Q1, dd=self._self_dd(b)), make)

    # -- Jacobi preconditioner ------------------------------------------------

    def _diag_H(self, state, b: BlockInfo, first: bool, term=None):
        """Exact diagonal of the block-table Hessian (oracle diag_hessian),
        or None under plain CG:

          cross: D[d,l] = lam reg[d] + X1s^T [ w diag(Q1^T Q1)
                                               + (1-w) pos-scatter of Q1^2 ]
          self : D[d,l] = lam reg[d] + X1s^T (dd_i Q1[i,l]^2)

        ``term``: the gradient pass's diagonal output — ("tbl", the whole
        scatter term) from a fused pass, or a cross solve's row-space posq;
        None for a self block off the fused path, whose term is scattered
        here, and for a cross block of a COO side, whose posq is summed here
        by the gradient pass's own formula (``pos_scatter_sq``, the pair's
        squared-only form; jax_solver.py:1946-1951).
        Clamped at 1e-12, so that a pad table row (D == 0, R == 0) gives
        R / D == 0, not NaN (jax_solver.py:1918-1961)."""
        if self.cg_precond != "jacobi":
            return None
        hp = self.meta.hp
        reg, _, _ = self._side(b, first)
        if isinstance(term, tuple):
            return (hp.lam * reg[:, None] + term[1]).clamp_min(1e-12)
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = state["params"][b.f12]["W" if first else "H"].shape[0]
        if b.kind == "uv":
            if term is None:
                coo = self._coo(first)
                if coo is None:
                    raise ValueError("a blocked side's diagonal term comes "
                                     "from its gradient pass")
                term = pos_scatter_sq(Q1, coo, 1.0 - hp.omega)
            # pad rows are zero
            Q1d = Q1.double()
            qtq_d, = self._row_sums([(Q1d * Q1d).sum(dim=0)], "gram")
            rowq = hp.omega * qtq_d[None, :] + term
        else:
            rowq = self._self_dd(b)[:, None] * (Q1 * Q1)
        D = hp.lam * reg[:, None] + self._scat_sq(b, first, rowq, dim)
        return D.clamp_min(1e-12)

    # -- conjugate gradient -----------------------------------------------------

    def _cg(self, hv, G: Tensor, D: Optional[Tensor] = None):
        """Newton-step CG (cg, ffm.cpp:744-813): stop when ||r||^2 <=
        cg_eps ||g||^2 or after cg_max_iter iterations.  With ``D``,
        Jacobi-preconditioned CG on the same system with the same
        true-residual stop rule: only the search directions change.  The
        recurrence runs at a float32 floor (``sparse_ops.cg_step``, on the
        card the kernel cg_ops.cu, its stop flag beside its scalars); Hv is
        evaluated at storage dtype.  Under a mesh every rank runs the same
        recurrence on the replicated variable (its dot products local, the
        same bits on every rank), and each Hv makes the iteration's one
        all-reduce."""
        if self.mesh is not None:
            with self.mesh.scope("cg"):
                return self._cg_loop(hv, G, D)
        return self._cg_loop(hv, G, D)

    def _graph_path(self) -> bool:
        """One process on the card, not asked for the host loop: each
        solve's CG runs as CUDA graph replays of ``cg_group`` iterations."""
        return (self._graphs is not None and self.mesh is None
                and not self.cg_host_loop)

    def _cg_loop(self, hv, G: Tensor, D: Optional[Tensor] = None):
        """(S at the CG floor, iteration count).  Under a mesh (or with
        ``cg_host_loop``) one eager iteration per host read of the stop
        flag: a masked iteration there would cost a mesh an Hv all-reduce.
        On one process ``cg_group`` iterations per read, those after the
        stop exact no-ops: on the card one CUDA graph replay each
        (``cg_graph``), on the CPU eager.  The count and S are those of a
        host test before every iteration, bit for bit."""
        hp = self.meta.hp
        args = (G, D, self.meta.dtype, hp.cg_eps, hp.cg_max_iter)
        counts = self.cg_counts
        if self._graph_path():
            S, it, replays = self._graphs.solve(hv, *args, self.cg_group)
            counts["reads"] += replays
            counts["replays"] += replays
            counts["masked"] += replays * self.cg_group - it
            return S, it
        st = cg_init(*args)
        host = self.mesh is not None or self.cg_host_loop
        group = 1 if host else self.cg_group
        done, it = cg_read(st) if host else (False, 0)
        counts["reads"] += host
        groups = 0
        while not done:
            if groups * group > hp.cg_max_iter:
                raise RuntimeError("CG ran past its cap without its stop")
            for _ in range(group):
                cg_step(st, hv(st.Vs))
            groups += 1
            done, it = cg_read(st)
            counts["reads"] += 1
        counts["masked"] += groups * group - it
        return st.S, it

    # -- block update -----------------------------------------------------------

    def _apply_step(self, state, b: BlockInfo, first: bool, S: Tensor,
                    rows_pre: Optional[Tensor],
                    rows_hd: Optional[Tensor] = None) -> Dict[str, Any]:
        """Apply the Newton step and refresh the cache and both sides' slot-
        order residuals (update_cross ffm.cpp:439-465, update_side 405-437).
        A cross step's gap kernel reuses the solve's stream: the other
        side's cache did not move; on a two-tier side the head stream
        ``rows_hd`` gives the head slots' gaps, and the other side's
        carries read the concatenated (tail, head) gaps through the
        cross-order maps.  A COO side's gaps are ``pos_dot`` over the
        stream (jax_solver.py:2201-2205).  A self step moves the side sum a
        (or b) by <dP, other cache> per row, and every positive of the row by
        the same amount, head slots included."""
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
            if (rows_hd is not None) != self._hd_side(first):
                raise ValueError("a cross step on a two-tier side needs the "
                                 "solve's head stream, and only there")
            pre, _, bm = self._blk(first)
            if self._coo(first) is None:
                gap = pos_gap_blocked(dP, rows_pre, d[pre + "own"], bm,
                                      runs=d[pre + "runs"])
            else:
                own_ids, oth_ids = self._stream_ids(first)
                other = (state["Q" if first else "P"][b.f12]
                         if rows_pre is None else rows_pre)
                gap = pos_dot(dP, own_ids, other, oth_ids)
            own, oth = ("u", "v") if first else ("v", "u")
            state["yt_" + own] = state["yt_" + own] + gap.reshape(
                state["yt_" + own].shape) * d[pre + "w"]
            gap = gap.reshape(-1)
            if rows_hd is not None:
                gap_hd = head_pq(dP.index_select(0, d[pre + "hd_row"]),
                                 rows_hd)
                state[f"yt_{own}_hd"] = (state[f"yt_{own}_hd"]
                                         + gap_hd * d[pre + "hd_w"])
                gap = torch.cat([gap, gap_hd.reshape(-1)])
            # the other order's slots read gaps of every rank's (tail,
            # head) slots
            gap = self._gather(gap, "carry")
            cross = d[f"blk_{oth}_from_{own}"].long()
            state["yt_" + oth] = state["yt_" + oth] \
                + gap[cross] * d[f"blk_{oth}_w"]
            if self._hd_side(not first):
                cross = d[f"blk_{oth}_hd_from_{own}"].long()
                state[f"yt_{oth}_hd"] = state[f"yt_{oth}_hd"] \
                    + gap[cross] * d[f"blk_{oth}_hd_w"]
            return state
        other = state["Q"][b.f12] if first else state["P"][b.f12]
        da = (dP * other).sum(dim=1)
        own, oth = ("u", "v") if b.kind == "uu" else ("v", "u")
        side_key = "a" if b.kind == "uu" else "b"
        state[side_key] = state[side_key] + da
        pre, _, bm = self._blk(b.kind == "uu")
        # own side: da per slot of its row (on a COO side a gather through
        # its ids); other side: the other order's take IS this side's row
        # id in that order (one scalar gather)
        da_all = self._gather(da, "carry")  # the other order's rows: any rank
        if self._coo(b.kind == "uu") is None:
            exp = expand_rows_blocked(da, d[pre + "own"], bm).reshape(
                state["yt_" + own].shape)
        else:
            exp = da[d[pre + "seg"].long()] * d[pre + "w"]
        state["yt_" + own] = state["yt_" + own] + exp
        state["yt_" + oth] = state["yt_" + oth] \
            + da_all[d[f"blk_{oth}_take"].long()] * d[f"blk_{oth}_w"]
        # head tiers: da per slot is the chunk's row's on the own side, a
        # scalar gather through hd_take on the other
        if self._hd_side(own == "u"):
            state[f"yt_{own}_hd"] = state[f"yt_{own}_hd"] + da.index_select(
                0, d[pre + "hd_row"])[:, None] * d[pre + "hd_w"]
        if self._hd_side(oth == "u"):
            state[f"yt_{oth}_hd"] = state[f"yt_{oth}_hd"] \
                + da_all[d[f"blk_{oth}_hd_take"].long()] \
                * d[f"blk_{oth}_hd_w"]
        return state

    def grad_and_hv(self, state, b: BlockInfo, first: bool, sa, sb):
        """(gradient, Hv closure, the solve's stream or None) for one table
        of a block.  In a cross solve the other side's cache is constant:
        its blocked stream is gathered once and every pass streams it."""
        return self.solve_inputs(state, b, first, sa, sb)[:3]

    def solve_inputs(self, state, b: BlockInfo, first: bool, sa, sb,
                     stream_buffers: bool = False):
        """(G, Hv closure, stream, head stream, D): ``grad_and_hv`` plus
        the head stream of a cross solve on a two-tier side (else None),
        gathered once per solve as the tail stream is, and the Jacobi
        diagonal (None under plain CG), whose scatter term the gradient's
        pass computes from the same read of the stream
        (jax_solver.py:2278-2298).  A COO side gathers no stream: its
        passes gather B's rows themselves (the stream is then None; under a
        mesh the other side's cache, gathered once).  A
        model-sharded table is gathered first (``_with_table``)."""
        state = self._with_table(state, b, first)
        jac = self.cg_precond == "jacobi"
        if b.kind != "uv":
            res = self._grad_self(state, b, first, sa, sb, want_diag=jac)
            G, term = res if jac else (res, None)
            return (G, self._hv_self(state, b, first), None, None,
                    self._diag_H(state, b, first, term))
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        pre = self._blk(first)[0]
        # the stream's rows are any rank's: gathered once per solve (a COO
        # side's passes read the gathered cache itself)
        rows_pre = None

        def stream(name: str, take: Tensor) -> Tensor:
            out = None
            if stream_buffers:
                out = self._graphs.buffer(name, (*take.shape, B1.shape[1]),
                                          B1.dtype)
            return gather_blocked_rows(B1, take, out=out)

        if self._coo(first) is None:
            B1 = self._gather(B1, "rows_pre")
            rows_pre = stream("rows_pre", self.data[pre + "take"])
        elif self.mesh is not None:
            B1 = rows_pre = self._gather(B1, "rows_pre")
        rows_hd = (stream("rows_hd", self.data[pre + "hd_take"])
                   if self._hd_side(first) else None)
        res = self._grad_cross(state, b, first, rows_pre, with_diag_pos=jac,
                               rows_hd=rows_hd)
        G, term = res if jac else (res, None)
        return (G, self._hv_cross(state, b, first, rows_pre, rows_hd),
                rows_pre, rows_hd, self._diag_H(state, b, first, term))

    def _solve_half(self, state, b: BlockInfo, first: bool, sa, sb):
        """Gradient, (P)CG and step for one table of a block, each a span
        inside the half-solve's; a model-sharded table is gathered once
        before and cut back to this rank's rows after."""
        with span("solve", f"f12={b.f12} kind={b.kind} "
                           f"table={'W' if first else 'H'}"):
            state = self._with_table(state, b, first)
            with span("grad"):
                G, hv, rows_pre, rows_hd, D = self.solve_inputs(
                    state, b, first, sa, sb,
                    stream_buffers=self._graph_path())
            with span("cg"):
                S, it = self._cg(hv, G, D)
            with span("step"):
                state = self._apply_step(state, b, first, S, rows_pre,
                                         rows_hd)
            return self._keep_rows(state, b, first), it

    # -- epoch ------------------------------------------------------------------

    def _epoch_impl(self, state):
        """One alternating sweep in reference order (one_epoch,
        ffm.cpp:852-870): per block the f1 table, then the f2 table.  sa/sb
        are built once, at the start (jax_solver.py:2304-2312): only
        self-block gradients read them, and a model without self blocks
        skips them."""
        lay = self.meta.layout
        with span("sasb"):
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
        ffm.cpp:1321-1351, without materializing m x n).  On a data mesh
        each rank sums over its true rows and stream slice: the global sums
        and Grams are all-reduced first, then the partial scalar sums (the
        tables are replicated)."""
        meta, d = self.meta, self.data
        hp = meta.hp
        P, Q = state["P"], state["Q"]
        m, n = meta.m_true, meta.n_true
        mu = max(0, min(self.m_l, m - self.lo_u))
        nv = max(0, min(self.n_l, n - self.lo_v))
        at, bt = state["a"][:mu], state["b"][:nv]
        cross = meta.layout.cross_blocks()
        alpha = at - hp.r
        Pt = [P[c.f12][:mu] for c in cross]
        Qt = [Q[c.f12][:nv] for c in cross]
        Pcat, Qcat = torch.cat(Pt, dim=1), torch.cat(Qt, dim=1)
        nc = len(cross)
        red = self._allreduce_many(
            [alpha.sum(), bt.sum(), Pcat.T @ Pcat, Qcat.T @ Qcat]
            + [x.sum(dim=0) for x in Pt] + [x.sum(dim=0) for x in Qt],
            "objective")
        sumP, sumQ = red[4:4 + nc], red[4 + nc:]
        part = n * (alpha ** 2).sum() + m * (bt ** 2).sum()
        for i in range(nc):
            part = part + 2.0 * (alpha @ (Pt[i] @ sumQ[i]))
            part = part + 2.0 * (bt @ (Qt[i] @ sumP[i]))
        yt, w = self.yt_stream(state), d["pos_w"]
        tot = self._allreduce_many(
            [part, (w * (yt + (1.0 - hp.r)) ** 2).sum(), (w * yt ** 2).sum()],
            "objective")
        e2 = tot[0] + 2.0 * red[0] * red[1] + (red[2] * red[3]).sum()
        loss = hp.omega * (e2 - tot[1]) + tot[2]
        params = self.full_params(state["params"], "objective")
        for b in self.blocks:
            reg1, _, _ = self._side(b, True)
            reg2, _, _ = self._side(b, False)
            prm = params[b.f12]
            loss = loss + hp.lam * (reg1[:, None] * prm["W"] ** 2).sum()
            loss = loss + hp.lam * (reg2[:, None] * prm["H"] ** 2).sum()
        return 0.5 * loss
