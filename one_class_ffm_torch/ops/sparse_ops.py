"""Sparse ops of the port: plain PyTorch versions and kernel dispatch.

Counterparts of ``one_class_ffm_tpu/ops/sparse_ops.py``.  The pre-gathered
stream is row-major, ``(n_blocks, MAXC, k)``: the k-major ("kt") layout of
the JAX package only worked around TPU lane padding of k < 128.  For the
same reason the fused table passes take a field's X untransposed,
``(rows, p)``; their X^T side is the field's static feature-major list
(``layout.FeatureMajor``).

The three blocked passes (``pos_hv_blocked``, ``pos_scatter_blocked``,
``pos_gap_blocked``), the four fused table-space passes (``pos_hv_tbl``,
``grad_cross_tbl``, ``hv_self_tbl``, ``grad_self_tbl``), the projection of
a feature field (``project``, B8) and the general scatter of a wide field
(``scatter``, the table passes' X^T stage on its own) each have a plain
version here (``*_plain``) and a hand-written CUDA kernel (csrc/*.cu via
ops/kernels.py).  Three of them take the Jacobi diagonal's second output
(``pos_scatter_blocked(w_blk=)``, ``grad_cross_tbl(w_blk=)``: a second
payload from the same read of the stream; ``grad_self_tbl(dd=)``: one from
Q1 and dd; scattered through the field's X^2).  Two Hv variants off the solver's path,
the lane-packed ``pos_hv_packed`` (B9) and ``pos_hv_blocked_g`` with G
blocks per CTA (B10), compute B1's function and serve ``hv_pack_bench``.
The head ops of a two-tier layout (``head_*``) are plain torch on every
device, as their JAX counterparts are XLA ops; the fused terms among them
run B8 and the X^T stage.  The positive passes of a side without a
blocked layout (``pos_scatter``, ``pos_scatter_pair`` and its squared-only
form ``pos_scatter_sq``, ``pos_seg_sum``, and the fused cross Hv
``pos_hv_coo``) sum through the side's destination-major list of the
stream, on the card by one kernel with five sources; ``pos_dot``, the
stream's gather-and-dot (the residual refresh, a COO side's gaps), has a
kernel of its own, as has ``topk_rows``, each row's top K of a score
matrix in a stable sort's order (predict's ranking).  The dispatching
function takes the plain version only because its tensors lie on the CPU;
on a CUDA tensor it launches the kernel or raises.
Storage is float32 or bfloat16 (float64 on the CPU), sums run at a
float32 floor, and the plain versions round where the kernels round: pq
to storage, the output to storage, and for the table passes phi = X V
and the per-row payload to storage, the (D, k) table-space result left at
the float32 floor (the general scatter casts it to storage).

The plain versions also add in the kernels' order, one rounding per
product and per sum (the kernels use no fused multiply-add): a k-long dot
is 32 lane sums folded by an xor butterfly, a row's slots are added in slot
order, then the dense term in column order.  At float32 and bfloat16 the
kernel and its plain version therefore agree bit for bit; a looser bound
would let a one-ulp flip of a bfloat16 pq or output, which different sum
orders do cause, pass for a kernel fault or hide one.  The table passes'
X^T stage adds each chunk of a feature's entries in list order, then the
feature's chunk sums in chunk order.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from . import kernels
from .layout import FeatureMajor, seg_sum_lanes

_NNZ_CHUNK = 1 << 21


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation type: a float32 floor that keeps float64."""
    return torch.promote_types(dt, torch.float32)


def _plain_device(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# the stream's gather-and-dot, and plain tensor ops (no kernel of their own)
# ---------------------------------------------------------------------------


def pos_dot_plain(A: torch.Tensor, u_ids: torch.Tensor, B: torch.Tensor,
                  v_ids: torch.Tensor,
                  max_chunk: int = _NNZ_CHUNK) -> torch.Tensor:
    """out[t] = storage(<A[u_ids[t]], B[v_ids[t]]>) over the COO stream, in
    bounded chunks: products at storage, summed at the accumulation type
    (``_dot_sum``), rounded once (the JAX ``pos_dot``, sparse_ops.py:215,
    an XLA gather-and-sum there).  Ids are clamped into range as XLA clamps
    its gathers: the pad entries' ghost ids may equal the row count (their
    weight is 0)."""
    acc = acc_dtype(A.dtype)
    u = u_ids.long().clamp(0, A.shape[0] - 1)
    v = v_ids.long().clamp(0, B.shape[0] - 1)
    parts = [_dot_sum((A[uc] * B[vc]).to(acc)).to(A.dtype)
             for uc, vc in zip(u.split(max_chunk), v.split(max_chunk))]
    return torch.cat(parts) if parts else A.new_zeros(0)


def _dot_sum(p: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of ``pos_dot``'s products: at float32 (the
    floor of float32 and bfloat16 storage) in the kernel's order,
    ``_lane_sum``; at float64, which runs only on the CPU, where no kernel
    runs and the tests hold the port to the JAX package and the oracle at
    rtol down to 1e-12, torch's own sum, as the JAX ``pos_dot`` takes
    XLA's."""
    return p.sum(dim=-1) if p.dtype == torch.float64 else _lane_sum(p)


def pos_dot(A: torch.Tensor, u_ids: torch.Tensor, B: torch.Tensor,
            v_ids: torch.Tensor, max_chunk: int = _NNZ_CHUNK) -> torch.Tensor:
    """The residual refresh's and a COO side's gaps' gather-and-dot
    (``pos_dot_plain``, in chunks of ``max_chunk``), its kernel on a CUDA
    tensor (int32 ids; it writes no gathered rows, so takes no chunks)."""
    if _plain_device(A):
        return pos_dot_plain(A, u_ids, B, v_ids, max_chunk)
    return kernels.pos_dot(A, u_ids, B, v_ids)


def gather_blocked_rows(B: torch.Tensor, take: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The solve's pre-gathered stream (n_blocks, MAXC, k): B is constant
    across a solve, so its random row gather is paid once and every pass
    streams the result.  ``out``: a contiguous (n_blocks, MAXC, k) tensor
    to gather into (a CUDA graph's stream buffer)."""
    nb, maxc = take.shape
    idx = take.reshape(-1).long()
    if out is None:
        return B.index_select(0, idx).reshape(nb, maxc, B.shape[1])
    torch.index_select(B, 0, idx, out=out.view(nb * maxc, B.shape[1]))
    return out


def _slot_rows(own: torch.Tensor, block_rows: int):
    """(global row of every slot, valid mask); pads map to their block's
    last row and are masked."""
    nb = own.shape[0]
    base = torch.arange(nb, device=own.device, dtype=torch.int64)[:, None]
    seg = base * block_rows + own.long().clamp(max=block_rows - 1)
    return seg, own < block_rows


_LANES = 32  # the kernels' warp width: a dot is 32 lane sums


def _lane_sum(p: torch.Tensor, lanes: int = _LANES) -> torch.Tensor:
    """sum(p, -1) in the kernels' order: lane l of ``lanes`` sums the values
    l, l + lanes, l + 2 lanes, ... in turn (past the end: +0), then an xor
    butterfly folds the lanes."""
    n = p.shape[-1]
    per_lane = max(1, -(-n // lanes))
    p = torch.nn.functional.pad(p, (0, per_lane * lanes - n))
    p = p.reshape(*p.shape[:-1], per_lane, lanes)
    lane = p[..., 0, :]
    for j in range(1, per_lane):
        lane = lane + p[..., j, :]
    ids = torch.arange(lanes, device=p.device)
    off = lanes // 2
    while off:
        lane = lane + lane[..., ids ^ off]
        off //= 2
    return lane[..., 0]


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) in the kernels' order: lane l sums the products
    l, l+32, l+64, ... in turn, then an xor butterfly folds the 32 lanes."""
    return _lane_sum(a * b)


def _row_runs(own: torch.Tensor, block_rows: int):
    """(flat slot index of each row's first slot, run length), per global
    row: within a block ``own`` is non-decreasing with the pads last, so a
    row's slots are one run, found by binary search."""
    nb, maxc = own.shape
    keys = torch.arange(block_rows + 1, device=own.device,
                        dtype=own.dtype).expand(nb, -1).contiguous()
    pos = torch.searchsorted(own.contiguous(), keys)  # (nb, block_rows + 1)
    base = torch.arange(nb, device=own.device)[:, None] * maxc
    start = (pos[:, :-1] + base).reshape(-1)
    return start, (pos[:, 1:] - pos[:, :-1]).reshape(-1)


def _run_sums(c_blk: torch.Tensor, own: torch.Tensor, block_rows: int):
    """Per-row sums of slot values at the accumulation type, each row's run
    added slot by slot in slot order (the self-gradient kernel's order)."""
    acc = acc_dtype(c_blk.dtype)
    flat = c_blk.reshape(-1).to(acc)
    start, length = _row_runs(own, block_rows)
    out = torch.zeros(start.shape, dtype=acc, device=c_blk.device)
    for j in range(int(length.max()) if length.numel() else 0):
        term = flat[(start + j).clamp(max=flat.numel() - 1)]
        out = out + torch.where(length > j, term, 0)
    return out


def _slot_sum(seg, valid, own, terms, num_out: int):
    """out[r] = sum of the (slot, k) ``terms`` of row r's slots, added one
    slot at a time in slot order (the kernels' order): pass j adds every
    row's j-th slot, so no row receives two terms in one pass."""
    nb, maxc = own.shape
    pos = torch.arange(maxc, device=own.device).expand(nb, maxc)
    first = torch.ones_like(valid)
    first[:, 1:] = own[:, 1:] != own[:, :-1]
    rank = (pos - torch.where(first, pos, 0).cummax(dim=1).values)[valid]
    slots = torch.nonzero(valid.reshape(-1)).squeeze(1)
    seg_v = seg.reshape(-1)[slots]
    terms_v = terms.reshape(-1, terms.shape[-1])[slots]
    order = torch.argsort(rank, stable=True)
    out = torch.zeros((num_out, terms.shape[-1]), dtype=terms.dtype,
                      device=terms.device)
    for g in order.split(torch.bincount(rank).tolist()):
        out.index_add_(0, seg_v[g], terms_v[g])
    return out


def seg_sum_blocked(c_blk: torch.Tensor, own: torch.Tensor, num_rows: int,
                    block_rows: int) -> torch.Tensor:
    """out[r] = sum of the slot-order values of row r's slots (the JAX
    package's ``seg_sum_blocked``, an XLA op there, plain torch here).  Pad
    slots add nothing.  One segmented reduction over the flat slots, whose
    segments are each block's row runs and then its pads; it sums at the
    accumulation type and uses no float atomics, so it is deterministic on
    the card too."""
    nb, maxc = own.shape
    if nb * block_rows != num_rows:
        raise ValueError(f"num_rows={num_rows} != n_blocks*block_rows="
                         f"{nb * block_rows}")
    _, length = _row_runs(own, block_rows)
    length = length.reshape(nb, block_rows)
    pads = maxc - length.sum(dim=1, keepdim=True)
    sums = torch.segment_reduce(
        c_blk.reshape(-1).to(acc_dtype(c_blk.dtype)), "sum",
        lengths=torch.cat([length, pads], dim=1).reshape(-1), unsafe=True)
    return sums.reshape(nb, block_rows + 1)[:, :block_rows].reshape(
        -1).to(c_blk.dtype)


def expand_rows_blocked(vec: torch.Tensor, own: torch.Tensor,
                        block_rows: int) -> torch.Tensor:
    """Per-slot copy of a per-row vector, flat in slot order: slot t gets
    vec[row owning t]; pad slots get exactly 0 (``expand_rows_blocked``)."""
    seg, valid = _slot_rows(own, block_rows)
    return torch.where(valid, vec[seg], 0).reshape(-1)


# ---------------------------------------------------------------------------
# blocked passes: plain versions
# ---------------------------------------------------------------------------


def pos_hv_blocked_plain(phi, rows, own, w_blk, dense_mat, num_out: int,
                         block_rows: int, w_scale: float = 1.0):
    """out[r] = sum_{t: own_t=r} w_scale w_t pq_t rows_t + phi[r] @ dense,
    pq_t = storage(<phi[r], rows_t>)  (pos_hv_blocked / pos_hv_kt_pallas)."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    seg, valid = _slot_rows(own, block_rows)
    rows_a = rows.to(acc)
    pq = _lane_dot(phi[seg].to(acc), rows_a).to(dt).to(acc)
    coef = pq * (torch.tensor(w_scale, dtype=acc) * w_blk.to(acc))
    out = _slot_sum(seg, valid, own, coef[..., None] * rows_a, num_out)
    phi_a, dense_a = phi.to(acc), dense_mat.to(acc)
    for i in range(dense_a.shape[0]):
        out = out + phi_a[:, i:i + 1] * dense_a[i][None, :]
    return out.to(dt)


def storage_scale(w_blk, scale: float):
    """storage(w * storage(scale)): the slot weights of the Jacobi
    diagonal's positive term, rounded as the TPU kernels round
    ``w_ref * jnp.asarray(wq_scale, dt)``.  The scale is rounded to storage
    on the host: a product of two storage values is exact at the float32
    floor, so multiplying by it as a Python scalar rounds once, as the
    product of two storage tensors does, and moves nothing to the card."""
    return w_blk * torch.tensor(scale, dtype=w_blk.dtype).item()


def pos_scatter_blocked_plain(c_blk, rows, own, num_out: int,
                              block_rows: int, w_blk=None,
                              wq_scale: float = 1.0):
    """zpos[r] = sum_{t: own_t=r} c_t rows_t (pos_scatter_kt_pallas).  With
    ``w_blk`` also the Jacobi diagonal's positive term from the same slots,
    returned as (zpos, posq):

        posq[r] = sum_{t: own_t=r} storage(storage(rows_t^2) * wq_t),
        wq_t = storage(w_t * storage(wq_scale)),

    the payload formed at storage dtype, as ``_scatter_kt_kernel`` forms
    it, summed at the float32 floor in slot order, cast once to storage."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    seg, valid = _slot_rows(own, block_rows)
    terms = c_blk.to(acc)[..., None] * rows.to(acc)
    zpos = _slot_sum(seg, valid, own, terms, num_out).to(dt)
    if w_blk is None:
        return zpos
    termq = (rows * rows) * storage_scale(w_blk, wq_scale)[..., None]
    return zpos, _slot_sum(seg, valid, own, termq.to(acc), num_out).to(dt)


def pos_gap_blocked_plain(dP, rows, own, block_rows: int):
    """gap_t = <dP[own_t], rows_t> flat in slot order, pads exactly 0
    (pos_gap_kt_pallas)."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    seg, valid = _slot_rows(own, block_rows)
    gap = _lane_dot(dP[seg].to(acc), rows.to(acc))
    return torch.where(valid, gap, 0).to(dt).reshape(-1)


# ---------------------------------------------------------------------------
# blocked passes: dispatch (CPU -> plain, CUDA -> kernel)
# ---------------------------------------------------------------------------


def pos_hv_blocked(phi, rows, own, w_blk, dense_mat, num_out: int,
                   block_rows: int, w_scale: float = 1.0, runs=None):
    """The per-CG-iteration positive pass with the fused omega term.
    ``runs``: the rows' runs of slots (``layout.row_runs`` of ``own``),
    which the kernel reads in place of ``own``; the plain version needs
    ``own`` only."""
    if _plain_device(rows):
        return pos_hv_blocked_plain(phi, rows, own, w_blk, dense_mat,
                                    num_out, block_rows, w_scale)
    return kernels.pos_hv_blocked(phi, rows, own, w_blk, dense_mat, num_out,
                                  block_rows, w_scale, runs=runs)


def pos_scatter_blocked(c_blk, rows, own, num_out: int, block_rows: int,
                        w_blk=None, wq_scale: float = 1.0, runs=None):
    """The gradient's positive scatter; with ``w_blk`` (Jacobi) also the
    diagonal's positive term from the same read of the stream.  ``runs``:
    the rows' runs of slots (``layout.row_runs`` of ``own``), which the
    kernel reads in place of a search; the plain version needs ``own``
    only."""
    if _plain_device(rows):
        return pos_scatter_blocked_plain(c_blk, rows, own, num_out,
                                         block_rows, w_blk, wq_scale)
    if w_blk is None:
        return kernels.pos_scatter_blocked(c_blk, rows, own, num_out,
                                           block_rows, runs=runs)
    return kernels.pos_scatter_blocked_diag(c_blk, rows, own, num_out,
                                            block_rows, w_blk, wq_scale,
                                            runs=runs)


def pos_gap_blocked(dP, rows, own, block_rows: int, runs=None):
    """The residual gap after a step, flat in slot order.  ``runs``: the
    rows' runs of slots (``layout.row_runs`` of ``own``), which the kernel
    reads in place of the owners; the plain version needs ``own`` only."""
    if _plain_device(rows):
        return pos_gap_blocked_plain(dP, rows, own, block_rows)
    return kernels.pos_gap_blocked(dP, rows, own, block_rows, runs=runs)


# ---------------------------------------------------------------------------
# fused table-space passes: plain versions
# ---------------------------------------------------------------------------


def _list_values(xt: FeatureMajor, squared: bool):
    """The entry values the X^T stage multiplies by: X's, or X^2's."""
    if not squared:
        return xt.val
    if xt.val_sq is None:
        raise ValueError("the feature-major list carries no squared values "
                         "(val_sq): the Jacobi diagonal needs X^2")
    return xt.val_sq


def _list_sums(xt: FeatureMajor, terms, k: int, acc: torch.dtype,
               device) -> torch.Tensor:
    """(d, k) at the accumulation type: per feature of the list, the sum of
    its entries' terms in the X^T stage's order, each chunk's entries in
    list order, then the feature's chunk sums in chunk order.
    ``terms(e)``: the (chunks, k) terms at ``acc`` of the entries ``e``, one
    per chunk."""
    cptr, fptr = xt.chunk_ptr.long(), xt.feat_ptr.long()
    n_chunks, d = cptr.numel() - 1, fptr.numel() - 1
    part = torch.zeros((max(n_chunks, 1), k), dtype=acc, device=device)
    if n_chunks:
        start, length = cptr[:-1], cptr[1:] - cptr[:-1]
        last = xt.row.numel() - 1
        for j in range(int(length.max())):
            term = terms((start + j).clamp(max=last))
            part = part + torch.where((length > j)[:, None], term, 0)
    out = torch.zeros((d, k), dtype=acc, device=device)
    start, length = fptr[:-1], fptr[1:] - fptr[:-1]
    for j in range(int(length.max()) if d else 0):
        ch = (start + j).clamp(max=part.shape[0] - 1)
        out = out + torch.where((length > j)[:, None], part[ch], 0)
    return out


def _xt_scatter_plain(payload: torch.Tensor, xt: FeatureMajor,
                      squared: bool = False):
    """(d, k) = X^T payload (X^2 with ``squared``) at the accumulation type,
    in the kernels' order (``_list_sums``)."""
    acc = acc_dtype(payload.dtype)
    vals = _list_values(xt, squared)
    return _list_sums(
        xt, lambda e: (vals[e].to(acc)[:, None]
                       * payload[xt.row[e].long()].to(acc)),
        payload.shape[1], acc, payload.device)


def pos_hv_tbl_plain(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
                     block_rows: int, w_scale: float = 1.0):
    """X^T [B1 math on phib] with phib = storage(X V): the cross-block Hv of
    a small-D field in table space (pos_hv_tbl_pallas / _kt_pallas)."""
    num = own.shape[0] * block_rows
    zpb = pos_hv_blocked_plain(project_plain(x_idx, x_val, V), rows, own,
                               w_blk, dense_mat, num, block_rows, w_scale)
    return _xt_scatter_plain(zpb, xt)


def grad_cross_tbl_plain(xt, rows, own, c_blk, dense, block_rows: int,
                         w_blk=None, wq_scale: float = 1.0):
    """X^T storage(dense + storage(blocked scatter of c)): the cross-block
    gradient of a small-D field in table space (grad_cross_tbl_pallas /
    _kt_pallas).  With ``w_blk`` also the Jacobi diagonal's positive term
    in table space, returned as (Gt, Qt):

        Qt = (X^2)^T posq,  posq[r] = storage(sum_{t: own_t=r} wq_t rows_t^2)

    with wq_t = storage(w_t * storage(wq_scale)) and rows_t^2 at storage
    dtype, their product at the float32 floor (the TPU kernel's one-hot
    matmul of (w * wq) against rows * rows); Qt stays unrounded."""
    payload, posq = grad_cross_payload_plain(rows, own, c_blk, dense,
                                             block_rows, w_blk, wq_scale)
    gt = _xt_scatter_plain(payload, xt)
    if w_blk is None:
        return gt
    return gt, _xt_scatter_plain(posq, xt, squared=True)


def grad_cross_payload_plain(rows, own, c_blk, dense, block_rows: int,
                             w_blk=None, wq_scale: float = 1.0):
    """The per-row payloads of ``grad_cross_tbl_plain`` at storage dtype,
    (payload, posq), posq None without ``w_blk``:
    payload = storage(dense + storage(blocked scatter of c)), posq as
    there."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    num = dense.shape[0]
    zpos = pos_scatter_blocked_plain(c_blk, rows, own, num, block_rows)
    payload = (dense.to(acc) + zpos.to(acc)).to(dt)
    if w_blk is None:
        return payload, None
    seg, valid = _slot_rows(own, block_rows)
    termq = (storage_scale(w_blk, wq_scale).to(acc)[..., None]
             * (rows * rows).to(acc))
    return payload, _slot_sum(seg, valid, own, termq, num).to(dt)


def hv_self_tbl_plain(V, x_idx, x_val, xt, Q1, dd):
    """X^T diag(dd <Q1, X V>) Q1 with the storage roundings of phib, the
    dot, s and the payload: the self-block Hv of a small-D field in table
    space (hv_self_tbl_pallas / _kt_pallas)."""
    dt, acc = Q1.dtype, acc_dtype(Q1.dtype)
    q = Q1.to(acc)
    dot = _lane_dot(q, project_plain(x_idx, x_val, V).to(acc))
    s = (dd.to(acc) * dot.to(dt).to(acc)).to(dt).to(acc)
    return _xt_scatter_plain((s[:, None] * q).to(dt), xt)


def grad_self_tbl_plain(xt, Q1, zdense, own, c_blk, block_rows: int,
                        dd=None):
    """X^T diag(storage(zdense + per-row sums of c)) Q1: the self-block
    gradient of a small-D field in table space (grad_self_tbl_pallas /
    _kt_pallas).  With ``dd`` also the Jacobi diagonal's term, returned as
    (Gt, Dq): Dq = (X^2)^T storage(storage(dd Q1) Q1), unrounded."""
    dt, acc = Q1.dtype, acc_dtype(Q1.dtype)
    zb = (zdense.to(acc) + _run_sums(c_blk, own, block_rows)).to(dt)
    gt = _xt_scatter_plain((zb.to(acc)[:, None] * Q1.to(acc)).to(dt), xt)
    if dd is None:
        return gt
    return gt, _xt_scatter_plain((dd[:, None] * Q1) * Q1, xt, squared=True)


# ---------------------------------------------------------------------------
# the projection of a feature field (B8) and the general scatter X^T Z
# ---------------------------------------------------------------------------


def project_plain(idx: torch.Tensor, val: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    """P[i] = storage(sum_s val[i, s] W[idx[i, s]]) in B8's order, with
    ``project_pallas``'s rounding: each row's slot products added in slot
    order at the accumulation type, one rounding per product and per sum,
    one cast to storage at the end.  At float32 and float64 that is
    ``project_xla``'s slot-order sum bit for bit; at bfloat16 project_xla
    rounds every product and sum to bfloat16 instead.  Ids outside the
    table add nothing, as the TPU kernel's one-hot X drops them.  The fused
    table passes' phi = X V is this function too.  Mixed value and table
    types promote, as ``project_xla``'s products do (B8 takes one type)."""
    dt = torch.promote_types(val.dtype, W.dtype)
    acc = acc_dtype(dt)
    d = W.shape[0]
    out = torch.zeros((idx.shape[0], W.shape[1]), dtype=acc, device=W.device)
    for s in range(idx.shape[1]):
        f = idx[:, s].long()
        term = val[:, s].to(acc)[:, None] * W[f.clamp(0, d - 1)].to(acc)
        out = out + torch.where(((f >= 0) & (f < d))[:, None], term, 0)
    return out.to(dt)


def project(idx: torch.Tensor, val: torch.Tensor,
            W: torch.Tensor) -> torch.Tensor:
    """P = X W of a feature field (``project``): B8 on a CUDA tensor."""
    if _plain_device(W):
        return project_plain(idx, val, W)
    return kernels.project(idx, val, W)


def scatter_plain(xt: FeatureMajor, Z: torch.Tensor,
                  squared: bool = False) -> torch.Tensor:
    """G = X^T Z (X^2 with ``squared``) through the field's feature-major
    list, summed at the accumulation type in the X^T stage's order, then
    cast once to storage."""
    return _xt_scatter_plain(Z, xt, squared).to(Z.dtype)


def scatter(xt: FeatureMajor, Z: torch.Tensor,
            squared: bool = False) -> torch.Tensor:
    """G = X^T Z of a feature field of any width (the JAX package's
    ``scatter(idx, val, Z, d)``, an XLA segment sum there; ``xt`` holds
    idx, val and d); with ``squared``, (X^2)^T Z through the list's
    ``val_sq`` (the JAX ``scatter(idx, val * val, Z, d)`` of the Jacobi
    diagonal).  Pad rows (val == 0) are not in the list.  On a CUDA tensor
    it runs the X^T stage kernel: per-feature sums in a fixed order, no
    float atomics, so the result is deterministic.  Returns storage, as
    ``scatter_xla`` returns Z's dtype."""
    if _plain_device(Z):
        return scatter_plain(xt, Z, squared)
    return kernels.scatter(xt, Z, squared)


# ---------------------------------------------------------------------------
# fused table-space passes: dispatch (CPU -> plain, CUDA -> kernel).  Each
# returns the (D, k) table-space result at the float32 floor, unrounded.
# ---------------------------------------------------------------------------


def pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
               block_rows: int, w_scale: float = 1.0, runs=None):
    """The per-CG-iteration cross-block pass of a small-D field (``runs``
    as in ``pos_hv_blocked``)."""
    if _plain_device(rows):
        return pos_hv_tbl_plain(V, x_idx, x_val, xt, rows, own, w_blk,
                                dense_mat, block_rows, w_scale)
    return kernels.pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk,
                              dense_mat, block_rows, w_scale, runs=runs)


def grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows: int,
                   w_blk=None, wq_scale: float = 1.0, runs=None):
    """The cross-block gradient pass of a small-D field.  Only its X^T side
    reads the field (through ``xt``): the payload is per data row.  With
    ``w_blk`` (Jacobi) it also returns the diagonal's table-space term.
    ``runs`` as in ``pos_scatter_blocked``."""
    if _plain_device(rows):
        return grad_cross_tbl_plain(xt, rows, own, c_blk, dense, block_rows,
                                    w_blk, wq_scale)
    if w_blk is None:
        return kernels.grad_cross_tbl(xt, rows, own, c_blk, dense,
                                      block_rows, runs=runs)
    return kernels.grad_cross_tbl_diag(xt, rows, own, c_blk, dense,
                                       block_rows, w_blk, wq_scale,
                                       runs=runs)


def hv_self_tbl(V, x_idx, x_val, xt, Q1, dd):
    """The per-CG-iteration self-block pass of a small-D field."""
    if _plain_device(Q1):
        return hv_self_tbl_plain(V, x_idx, x_val, xt, Q1, dd)
    return kernels.hv_self_tbl(V, x_idx, x_val, xt, Q1, dd)


def grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows: int, dd=None,
                  runs=None):
    """The self-block gradient pass of a small-D field; with ``dd``
    (Jacobi) it also returns the diagonal's table-space term.  ``runs`` as
    in ``pos_gap_blocked``."""
    if _plain_device(Q1):
        return grad_self_tbl_plain(xt, Q1, zdense, own, c_blk, block_rows,
                                   dd)
    if dd is None:
        return kernels.grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows,
                                     runs=runs)
    return kernels.grad_self_tbl_diag(xt, Q1, zdense, own, c_blk,
                                      block_rows, dd, runs=runs)


# ---------------------------------------------------------------------------
# the positive passes of a side without a blocked layout (a COO side)
# ---------------------------------------------------------------------------
#
# Counterparts of the JAX package's ``pos_scatter`` and ``pos_scatter_pair``
# (sparse_ops.py:230, :264), of the self blocks' scalar
# ``jax.ops.segment_sum`` of the stream's coefficients (jax_solver.py:1215)
# and of its COO Hv, ``pos_dot`` then ``pos_scatter`` of (1 - omega) pq
# (jax_solver.py:1900-1901), XLA ops there.  Here each sums its rows'
# entries through the side's destination-major list of the positive stream
# (``layout.coo_list``: pads and ghost ids dropped, a row's entries in
# stream order, power rows cut into chunks; ``val`` the stream's weight w
# of each entry in list order, permuted once when the list is built), at
# the float32 floor in the X^T stage's order, and rounds once to storage;
# the per-entry product is rounded to storage first, as the JAX ops form
# ``w[:, None] * B[take]`` at storage dtype.  The width-1 sums add a
# chunk's entries in 1 or 8 lanes (``_lane_sum``; ``layout.seg_sum_lanes``
# picks from the list's chunk lengths).  On a CUDA tensor each is
# one launch of coo_list_kernel (coo_ops.cu), which gathers B's rows itself
# (the (nnz, k) payload is never written), with no float atomics: the same
# bits on every run, and the plain versions' bits.  At float32 only the
# order of the sums differs from the JAX ops; at bfloat16 the JAX ops add
# at storage, these once at the end.

def _coo_check(coo: FeatureMajor, B=None, weights: bool = False) -> None:
    if coo.pos is None:
        raise ValueError("not a destination-major list of the positive "
                         "stream (it holds no stream positions)")
    if B is not None and B.shape[0] != coo.n_rows:
        raise ValueError(f"the list gathers from {coo.n_rows} rows, the "
                         f"table has {B.shape[0]}")
    if weights and coo.val is None:
        raise ValueError("the list carries no weights (val: the stream's w "
                         "in list order)")


def _coo_terms(coef, B: torch.Tensor, coo: FeatureMajor, squared: bool):
    """terms(e) of ``_list_sums``: storage(coef(e) B[row]) per entry, or with
    ``squared`` storage(storage(coef(e) B[row]) B[row]), at the accumulation
    type; ``coef(e)`` the entries' scalars at storage dtype."""
    dt, acc = B.dtype, acc_dtype(B.dtype)

    def terms(e):
        rows = B[coo.row[e].long()].to(acc)
        t = (coef(e).to(acc)[:, None] * rows).to(dt)
        if squared:
            t = (t.to(acc) * rows).to(dt)
        return t.to(acc)
    return terms


def _coo_sums(coef, B, coo: FeatureMajor, squared: bool = False):
    """(rows, k) storage: ``_list_sums`` of ``_coo_terms``, rounded once."""
    return _list_sums(coo, _coo_terms(coef, B, coo, squared), B.shape[1],
                      acc_dtype(B.dtype), B.device).to(B.dtype)


def pos_scatter_plain(c, B, coo: FeatureMajor) -> torch.Tensor:
    """out[s] = storage(sum over row s's entries t of storage(c[t]
    B[take_t])), (rows, k)."""
    _coo_check(coo, B)
    return _coo_sums(lambda e: c[coo.pos[e].long()], B, coo)


def pos_scatter_sq_plain(B, coo: FeatureMajor, wq_scale: float = 1.0):
    """The Jacobi diagonal's positive term posq[s] = storage(sum_t
    storage(storage(wq_t B[take_t]) B[take_t])), wq = storage(w *
    storage(wq_scale)) from the list's weights (the JAX ``wb * rows *
    rows``, wb = (1 - omega) w)."""
    _coo_check(coo, B, weights=True)
    wq = storage_scale(coo.val, wq_scale)
    return _coo_sums(lambda e: wq[e], B, coo, squared=True)


def pos_scatter_pair_plain(c, B, coo: FeatureMajor, wq_scale: float = 1.0):
    """(zpos, posq): ``pos_scatter_plain`` of c and
    ``pos_scatter_sq_plain``; with ``c`` None (None, posq)."""
    posq = pos_scatter_sq_plain(B, coo, wq_scale)
    return (None if c is None else pos_scatter_plain(c, B, coo)), posq


def pos_seg_sum_plain(c, coo: FeatureMajor,
                      lanes: int | None = None) -> torch.Tensor:
    """out[s] = storage(sum over row s's entries t of c[t]), (rows,): the
    self blocks' per-row sums of the stream's coefficients.  A chunk's
    entries are added in ``_lane_sum``'s order on ``lanes`` lanes (by
    default the list's own, ``layout.seg_sum_lanes``: 1 or 8), then a row's
    chunk sums in chunk order."""
    _coo_check(coo)
    if lanes is None:
        lanes = seg_sum_lanes(coo.chunk_ptr.cpu())
    acc = acc_dtype(c.dtype)
    cptr, fptr = coo.chunk_ptr.long(), coo.feat_ptr.long()
    start, length = cptr[:-1], cptr[1:] - cptr[:-1]
    n_chunks, d = length.numel(), fptr.numel() - 1
    if n_chunks == 0:
        return c.new_zeros(d)
    width = -(-int(length.max()) // lanes) * lanes
    j = torch.arange(width, device=c.device)
    e = (start[:, None] + j[None, :]).clamp(max=max(coo.pos.numel() - 1, 0))
    vals = torch.where(j[None, :] < length[:, None],
                       c[coo.pos[e].long()].to(acc), 0)
    part = _lane_sum(vals, lanes)[:, None]
    out = torch.zeros((d, 1), dtype=acc, device=c.device)
    start, length = fptr[:-1], fptr[1:] - fptr[:-1]
    for k in range(int(length.max()) if d else 0):
        ch = (start + k).clamp(max=n_chunks - 1)
        out = out + torch.where((length > k)[:, None], part[ch], 0)
    return out[:, 0].to(c.dtype)


def pos_hv_coo_plain(phi, B, coo: FeatureMajor, w_scale: float = 1.0):
    """The cross Hv's positive term of a COO side in one pass: out[s] =
    storage(sum over row s's entries t of storage(cv_t B[take_t])), cv_t =
    storage(storage(storage(<phi[s], B[take_t]>) w_t) storage(w_scale)),
    the dot ``pos_dot``'s, w the list's weights.  The same function and
    bits as ``pos_scatter(storage_scale(pos_dot(phi, own, B, other) * w,
    w_scale), B, coo)`` over the stream (the JAX two-call form)."""
    _coo_check(coo, B, weights=True)
    dt, acc = B.dtype, acc_dtype(B.dtype)
    fptr = coo.feat_ptr.long()
    counts = coo.chunk_ptr.long()[fptr[1:]] - coo.chunk_ptr.long()[fptr[:-1]]
    seg = torch.repeat_interleave(
        torch.arange(fptr.numel() - 1, device=B.device), counts)
    scale = torch.tensor(w_scale, dtype=dt).item()

    def coef(e):
        rows = B[coo.row[e].long()]
        dot = _dot_sum((phi[seg[e]] * rows).to(acc)).to(dt)
        return (dot * coo.val[e]) * scale
    return _coo_sums(coef, B, coo)


def pos_scatter(c, B, coo: FeatureMajor) -> torch.Tensor:
    """The gradient's positive scatter of a COO side:
    ``pos_scatter_plain``'s function, its kernel on a CUDA tensor."""
    if _plain_device(B):
        return pos_scatter_plain(c, B, coo)
    return kernels.pos_scatter(c, B, coo)


def pos_scatter_pair(c, B, coo: FeatureMajor, wq_scale: float = 1.0):
    """The gradient's positive scatter and the Jacobi diagonal's positive
    term of a COO side (``pos_scatter_pair_plain``), one launch of the
    kernel on a CUDA tensor, both from one read of each row."""
    if _plain_device(B):
        return pos_scatter_pair_plain(c, B, coo, wq_scale)
    return kernels.pos_scatter_pair(c, B, coo, wq_scale)


def pos_scatter_sq(B, coo: FeatureMajor, wq_scale: float = 1.0):
    """The Jacobi diagonal's positive term alone (``pos_scatter_sq_plain``):
    on a CUDA tensor the pair's kernel in its squared-only form."""
    if _plain_device(B):
        return pos_scatter_sq_plain(B, coo, wq_scale)
    return kernels.pos_scatter_pair(None, B, coo, wq_scale)[1]


def pos_seg_sum(c, coo: FeatureMajor) -> torch.Tensor:
    """The self blocks' per-row sums of a COO side's coefficients
    (``pos_seg_sum_plain``), the kernel's width-1 form on a CUDA tensor."""
    if _plain_device(c):
        return pos_seg_sum_plain(c, coo)
    return kernels.pos_seg_sum(c, coo)


def pos_hv_coo(phi, B, coo: FeatureMajor, w_scale: float = 1.0):
    """The cross Hv's positive term of a COO side (``pos_hv_coo_plain``),
    one launch of the kernel on a CUDA tensor."""
    if _plain_device(B):
        return pos_hv_coo_plain(phi, B, coo, w_scale)
    return kernels.pos_hv_coo(phi, B, coo, w_scale)


# ---------------------------------------------------------------------------
# the head tier of a two-tier layout (a popularity-skewed side)
# ---------------------------------------------------------------------------
#
# Counterparts of the JAX package's head ops (sparse_ops.py:911-988), plain
# torch on every device: XLA ops there, no Pallas kernel.  Every positive
# pass is linear in the stream entries, so the tail tier runs the blocked
# passes and kernels with the head entries dropped and these ops add the
# head entries' part; the dense omega terms are not repeated, since the
# tail still spans every row.  A chunk holds CHUNK consecutive entries of
# one head row.  The head stream is row-major, (NCH, CHUNK, k), gathered
# per solve by ``gather_blocked_rows``.  Chunk products are batched matrix
# products at the float32 floor (true float32: TF32 is off).
#
# Where the JAX ops scatter-add chunk sums into rows (``.at[hd_row].add``),
# these sum each head row's chunks through the static chunk table
# (``layout.head_chunk_table``) in one reduction at the accumulation type,
# then write the rows by unique index: no float atomics, the same bits on
# every run.  At float32 and float64 only the order of those sums differs
# from the JAX ops; at bfloat16 the JAX ops round after every add of a
# chunk sum (``head_scatter``, ``head_hv``, the solver's ``z_hd``), and
# these round once.
#
# The JAX ``head_project`` and ``head_tbl_scatter`` are the port's
# ``project`` (B8) on the head rows' field data and ``scatter`` (the X^T
# stage) through the head rows' feature-major list: the same rounding
# (float32 sums, one cast to storage), so the solver calls those.


def head_chunk_sums(c_hd: torch.Tensor, rows_hd: torch.Tensor):
    """out[c] = sum_t c_hd[c, t] rows_hd[c, t]: (NCH, CHUNK) x (NCH, CHUNK,
    k) -> (NCH, k), summed at the accumulation type, one cast to
    storage."""
    acc = acc_dtype(rows_hd.dtype)
    z = torch.bmm(c_hd.to(acc).unsqueeze(1), rows_hd.to(acc))
    return z.squeeze(1).to(rows_hd.dtype)


def head_pq(phig: torch.Tensor, rows_hd: torch.Tensor) -> torch.Tensor:
    """pq[c, t] = <phig[c], rows_hd[c, t]>: (NCH, k) x (NCH, CHUNK, k) ->
    (NCH, CHUNK), summed at the accumulation type, one cast to storage (pad
    slots are masked by the caller's weights)."""
    acc = acc_dtype(rows_hd.dtype)
    pq = torch.bmm(rows_hd.to(acc), phig.to(acc).unsqueeze(2))
    return pq.squeeze(2).to(rows_hd.dtype)


def head_row_sums(z_c: torch.Tensor, hd_tab: torch.Tensor) -> torch.Tensor:
    """Per head row, the sum of its chunks' values (NCH, ...) -> (NH, ...),
    at the accumulation type: one gather through the chunk table, whose
    unused places name a zero row past the last chunk, and one reduction."""
    z = torch.nn.functional.pad(z_c.to(acc_dtype(z_c.dtype)),
                                (0, 0) * (z_c.dim() - 1) + (0, 1))
    nh, width = hd_tab.shape
    return z.index_select(0, hd_tab.reshape(-1)).reshape(
        nh, width, *z_c.shape[1:]).sum(dim=1)


def head_row_payload(c_hd: torch.Tensor, rows_hd: torch.Tensor,
                     hd_tab: torch.Tensor) -> torch.Tensor:
    """(NH, k) at the accumulation type: per head row, the sum over its
    entries of c rows_t (``head_chunk_sums``, then each row's chunk sums
    through the table)."""
    return head_row_sums(head_chunk_sums(c_hd, rows_hd), hd_tab)


def _rows_out(row_sums: torch.Tensor, hd_rows: torch.Tensor, num_rows: int,
              dt: torch.dtype) -> torch.Tensor:
    """(num_rows, ...) at storage: the head rows' sums cast once and written
    at their rows (unique, so a write, not an accumulation), zero
    elsewhere."""
    out = row_sums.new_zeros((num_rows, *row_sums.shape[1:]), dtype=dt)
    return out.index_copy_(0, hd_rows, row_sums.to(dt))


def head_seg_sum(c_hd: torch.Tensor, hd_tab: torch.Tensor,
                 hd_rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Per-row sums of head slot values, (NCH, CHUNK) -> (num_rows,): the
    chunk sums and each row's sum of them at the accumulation type, one
    cast at the end."""
    s = c_hd.to(acc_dtype(c_hd.dtype)).sum(dim=1)
    return _rows_out(head_row_sums(s, hd_tab), hd_rows, num_rows, c_hd.dtype)


def head_scatter(c_hd, rows_hd, hd_tab, hd_rows, num_out: int,
                 diag_w_hd=None):
    """Head form of the gradient scatter: out[r] = sum over r's head entries
    of c rows_t, (num_out, k) at storage; with ``diag_w_hd`` also the Jacobi
    diagonal's payload sum of diag_w rows_t^2 (rows_t^2 at storage), as
    (out, posq)."""
    dt = rows_hd.dtype
    out = _rows_out(head_row_payload(c_hd, rows_hd, hd_tab), hd_rows,
                    num_out, dt)
    if diag_w_hd is None:
        return out
    q = head_row_payload(diag_w_hd, rows_hd * rows_hd, hd_tab)
    return out, _rows_out(q, hd_rows, num_out, dt)


def head_hv(phi, rows_hd, wq_hd, hd_row, hd_tab, hd_rows,
            num_out: int) -> torch.Tensor:
    """Head form of the per-CG-iteration positive pass: zp[r] = sum over
    r's head entries of wq <phi_r, rows_t> rows_t, (num_out, k) at
    storage.  ``wq_hd``: the slots' scaled weights, storage(w *
    storage(w_scale)) (``storage_scale``; the JAX op takes w and w_scale
    and forms the same product).  The dense omega term is the tail
    pass's."""
    c = head_pq(phi.index_select(0, hd_row), rows_hd) * wq_hd
    return _rows_out(head_row_payload(c, rows_hd, hd_tab), hd_rows,
                     num_out, rows_hd.dtype)


# ---------------------------------------------------------------------------
# Hv variants off the solver's path (B9, B10): B1's function from a
# lane-packed stream, and B1 with G blocks per CTA
# ---------------------------------------------------------------------------

PACK_LANES = 128  # four k = 32 entries per packed row, as the TPU's lanes


def pack_rows(rows: torch.Tensor, own: torch.Tensor, w_blk: torch.Tensor):
    """(rows_p, own_p, w_p): a blocked stream (n_blocks, MAXC, 32) in the
    lane-packed layout (n_blocks, MAXC/4, 128) of ``pos_hv_packed_pallas``
    (scripts/hv_pack_bench.py pack_stream).  Entry e = j * MAXC/4 + c lands
    at [c, 32j:32j+32]; its owner and weight are copied to all 32 lanes of
    that group (int32 owners, storage-dtype weights)."""
    nb, maxc, k = rows.shape
    if maxc % 4 or 4 * k != PACK_LANES:
        raise ValueError(f"the packed layout needs k = {PACK_LANES // 4} and "
                         f"MAXC % 4 == 0, got k={k}, MAXC={maxc}")
    m4 = maxc // 4
    rows_p = rows.reshape(nb, 4, m4, k).transpose(1, 2).reshape(
        nb, m4, PACK_LANES)

    def scal(x, dtype):
        xp = x.reshape(nb, 4, m4).transpose(1, 2)[..., None]
        return xp.expand(nb, m4, 4, k).reshape(nb, m4, PACK_LANES).to(dtype)

    return rows_p, scal(own, torch.int32), scal(w_blk, rows.dtype)


def pack_stream(B: torch.Tensor, take: torch.Tensor, own: torch.Tensor,
                w_blk: torch.Tensor):
    """The per-solve relayout of the packed variant: B's rows gathered in
    slot order (``gather_blocked_rows``), then packed (``pack_rows``)."""
    return pack_rows(gather_blocked_rows(B, take), own, w_blk)


def unpack_rows(rows_p: torch.Tensor, own_p: torch.Tensor,
                w_p: torch.Tensor):
    """The inverse of ``pack_rows``: (rows, own, w_blk) in slot order, the
    owner and weight read from lane 0 of each 32-lane group."""
    nb, m4, lanes = rows_p.shape
    k = lanes // 4
    rows = rows_p.reshape(nb, m4, 4, k).transpose(1, 2).reshape(
        nb, 4 * m4, k)

    def scal(x):
        return x[:, :, ::k].transpose(1, 2).reshape(nb, 4 * m4)

    return rows, scal(own_p), scal(w_p)


def pos_hv_packed_plain(phi, rows_p, own_p, w_p, dense_mat, num_out: int,
                        block_rows: int, w_scale: float = 1.0):
    """B1's function (``pos_hv_blocked_plain``) read from the lane-packed
    stream: each row's slots walked in entry order e, so the result is B1's
    bit for bit (pos_hv_packed_pallas, whose own roundings differ)."""
    rows, own, w_blk = unpack_rows(rows_p, own_p, w_p)
    return pos_hv_blocked_plain(phi, rows, own, w_blk, dense_mat, num_out,
                                block_rows, w_scale)


def pos_hv_blocked_g_plain(phi, rows, own, w_blk, dense_mat, num_out: int,
                           block_rows: int, groups: int,
                           w_scale: float = 1.0):
    """B1 with G blocks per CTA (pos_hv_kt_g_pallas): the same function,
    the same bits as ``pos_hv_blocked_plain``."""
    if groups < 1 or rows.shape[0] % groups:
        raise ValueError(f"G={groups} must divide n_blocks={rows.shape[0]} "
                         "(pos_hv_kt_g_pallas's rule)")
    return pos_hv_blocked_plain(phi, rows, own, w_blk, dense_mat, num_out,
                                block_rows, w_scale)


def pos_hv_packed(phi, rows_p, own_p, w_p, dense_mat, num_out: int,
                  block_rows: int, w_scale: float = 1.0, runs=None):
    """B9 on a CUDA tensor, its plain version on a CPU one (``runs`` as in
    ``pos_hv_blocked``: the unpacked stream's row runs)."""
    if _plain_device(rows_p):
        return pos_hv_packed_plain(phi, rows_p, own_p, w_p, dense_mat,
                                   num_out, block_rows, w_scale)
    return kernels.pos_hv_packed(phi, rows_p, own_p, w_p, dense_mat,
                                 num_out, block_rows, w_scale, runs=runs)


def pos_hv_blocked_g(phi, rows, own, w_blk, dense_mat, num_out: int,
                     block_rows: int, groups: int, w_scale: float = 1.0,
                     runs=None):
    """B10 on a CUDA tensor, its plain version on a CPU one (``runs`` as in
    ``pos_hv_blocked``)."""
    if _plain_device(rows):
        return pos_hv_blocked_g_plain(phi, rows, own, w_blk, dense_mat,
                                      num_out, block_rows, groups, w_scale)
    return kernels.pos_hv_blocked_g(phi, rows, own, w_blk, dense_mat,
                                    num_out, block_rows, groups, w_scale,
                                    runs=runs)


# ---------------------------------------------------------------------------
# the CG recurrence of a Newton solve (the reference's while_loop body and
# cond, jax_solver.py FFMSolver._cg): its start and one iteration after the
# Hv, with the stop flag beside the scalars; on the card cg_ops.cu (K2).
# The plain versions sum with torch's own ``sum``, whose order on a CUDA
# tensor the kernels reproduce (``kernels.cg_config``): on the card the two
# agree bit for bit, and on either device a solve gives the bits of the
# eager torch loop the kernels replaced.
# ---------------------------------------------------------------------------

CgState = kernels.CgState


def cg_init_plain(G: torch.Tensor, D, storage, eps: float,
                  max_iter: int) -> CgState:
    """The plain version of ``kernels.cg_init`` (cg_init_kernel)."""
    ct = acc_dtype(G.dtype)
    Gc = G.to(ct)
    Dc = None if D is None else D.to(ct)
    Z = Gc if Dc is None else Gc / Dc
    g2 = (Gc * Gc).sum()
    rz = g2 if Dc is None else (Gc * Z).sum()
    thr = torch.tensor(eps, dtype=ct, device=G.device) * g2
    V = -Z
    sc = dict(g2=g2, r2=g2, rz=rz, thr=thr, it=0,
              done=not (0 < max_iter and bool(g2 > thr)))
    return CgState(S=torch.zeros_like(Gc), R=-Gc, V=V, Vs=V.to(storage),
                   D=Dc, sc=sc, part=None, max_iter=max_iter)


def cg_step_plain(st: CgState, Hv: torch.Tensor) -> None:
    """The plain version of ``kernels.cg_step``: one iteration of the
    reference's body after the Hv, its sums by torch's ``sum``, in place
    on ``st``; an iteration entered after the stop writes nothing."""
    sc = st.sc
    if sc["done"]:
        return
    Hc = Hv.to(st.S.dtype)
    one = torch.ones((), dtype=Hc.dtype, device=Hc.device)
    zero = torch.zeros((), dtype=Hc.dtype, device=Hc.device)
    den = (st.V * Hc).sum()
    # the degenerate-denominator guard (jax_solver.py FFMSolver._cg): a
    # converged f32 block can underflow V.Hv to 0: no step, and the stop
    ok = den > 0
    alpha = torch.where(ok, sc["rz"] / torch.where(ok, den, one), zero)
    st.S = st.S + alpha * st.V
    R = st.R = st.R - alpha * Hc
    r2 = torch.where(ok, (R * R).sum(), zero)
    Z = R if st.D is None else R / st.D
    rz = r2 if st.D is None else (R * Z).sum()
    beta = rz / torch.where(sc["rz"] > 0, sc["rz"], one)
    st.V = Z + beta * st.V
    st.Vs = st.V.to(st.Vs.dtype)
    it = sc["it"] + 1
    sc.update(r2=r2, rz=rz, it=it,
              done=not (it < st.max_iter and bool(r2 > sc["thr"])))


def cg_init(G: torch.Tensor, D, storage, eps: float, max_iter: int,
            out: Optional[CgState] = None) -> CgState:
    """The solve's start: plain on a CPU tensor, ``kernels.cg_init`` on a
    CUDA one (``out``: a CUDA graph's buffers to start in)."""
    if _plain_device(G):
        return cg_init_plain(G, D, storage, eps, max_iter)
    return kernels.cg_init(G, D, storage, eps, max_iter, out=out)


def cg_step(st: CgState, Hv: torch.Tensor) -> None:
    """One iteration after the Hv (``Hv`` at the state's storage dtype)."""
    if _plain_device(Hv):
        return cg_step_plain(st, Hv)
    return kernels.cg_step(st, Hv)


def cg_read(st: CgState):
    """(done, it): the host's read of the stop flag and the count, a span
    ``cg.read`` in a trace (on the card the host's wait for the card)."""
    with span("cg.read"):
        if isinstance(st.sc, dict):
            return st.sc["done"], st.sc["it"]
        return kernels.cg_read(st)


def cg_scalars(st: CgState):
    """The state's scalars as Python numbers by name (r2, rz, thr, g2, it,
    done, ...)."""
    if isinstance(st.sc, dict):
        return {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in st.sc.items()}
    return kernels.cg_scalars(st)


# ---------------------------------------------------------------------------
# each row's top K (jax.lax.top_k in the JAX package's ranking): the first
# K of a stable descending sort, ties to the lowest column; on the card
# topk_ops.cu
# ---------------------------------------------------------------------------

def topk_rows_plain(z: torch.Tensor, k: int):
    """(values, ids) of each row's top k: the first k columns of a stable
    descending sort of the row."""
    srt = torch.sort(z, dim=1, descending=True, stable=True)
    return srt.values[:, :k], srt.indices[:, :k]


def topk_rows(z: torch.Tensor, k: int):
    """(values, ids int64) of each row's top k of the 2-d ``z``, highest
    first and the lowest column first among equal values, bit for bit
    ``topk_rows_plain``: the plain version on the CPU; on a CUDA tensor the
    top-K kernel (float32 or bfloat16, 1 <= k <= 256, else it raises; rows
    that are not unit-stride are copied first).  The kernel's launch is a
    span ``topk`` in a trace: a launch through ctypes has no torch operation
    that the profiler could charge its device time to."""
    if _plain_device(z):
        return topk_rows_plain(z, k)
    if z.stride(1) != 1 or (z.shape[0] > 1 and z.stride(0) < z.shape[1]):
        z = z.contiguous()
    with span("topk"):
        return kernels.topk_rows(z, k)
