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
ops/kernels.py).  The dispatching function takes the plain version only
because its tensors lie on the CPU; on a CUDA tensor it launches the kernel
or raises.  Storage is float32 or bfloat16 (float64 on the CPU), sums run
at a float32 floor, and the plain versions round where the kernels round:
pq to storage, the output to storage, and for the table passes phi = X V
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

import torch

from . import kernels
from .layout import FeatureMajor

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
# plain tensor ops (no kernel of their own)
# ---------------------------------------------------------------------------


def pos_dot(A: torch.Tensor, u_ids: torch.Tensor, B: torch.Tensor,
            v_ids: torch.Tensor, max_chunk: int = _NNZ_CHUNK) -> torch.Tensor:
    """out[t] = <A[u_ids[t]], B[v_ids[t]]> over the COO stream, in bounded
    chunks.  Ids are clamped into range as XLA clamps its gathers: the pad
    entries' ghost ids may equal the row count (their weight is 0)."""
    u = u_ids.long().clamp(max=A.shape[0] - 1)
    v = v_ids.long().clamp(max=B.shape[0] - 1)
    parts = [(A[uc] * B[vc]).sum(dim=1)
             for uc, vc in zip(u.split(max_chunk), v.split(max_chunk))]
    return torch.cat(parts) if parts else A.new_zeros(0)


def gather_blocked_rows(B: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """The solve's pre-gathered stream (n_blocks, MAXC, k): B is constant
    across a solve, so its random row gather is paid once and every pass
    streams the result."""
    nb, maxc = take.shape
    return B.index_select(0, take.reshape(-1).long()).reshape(
        nb, maxc, B.shape[1])


def _slot_rows(own: torch.Tensor, block_rows: int):
    """(global row of every slot, valid mask); pads map to their block's
    last row and are masked."""
    nb = own.shape[0]
    base = torch.arange(nb, device=own.device, dtype=torch.int64)[:, None]
    seg = base * block_rows + own.long().clamp(max=block_rows - 1)
    return seg, own < block_rows


_LANES = 32  # the kernels' warp width: a dot is 32 lane sums


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) in the kernels' order: lane l sums the products
    l, l+32, l+64, ... in turn, then an xor butterfly folds the 32 lanes."""
    k = a.shape[-1]
    per_lane = -(-k // _LANES)
    p = torch.nn.functional.pad(a * b, (0, per_lane * _LANES - k))
    p = p.reshape(*p.shape[:-1], per_lane, _LANES)
    lane = p[..., 0, :]
    for j in range(1, per_lane):
        lane = lane + p[..., j, :]
    ids = torch.arange(_LANES, device=a.device)
    for off in (16, 8, 4, 2, 1):
        lane = lane + lane[..., ids ^ off]
    return lane[..., 0]


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


def pos_scatter_blocked_plain(c_blk, rows, own, num_out: int,
                              block_rows: int):
    """zpos[r] = sum_{t: own_t=r} c_t rows_t (pos_scatter_kt_pallas)."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    seg, valid = _slot_rows(own, block_rows)
    terms = c_blk.to(acc)[..., None] * rows.to(acc)
    return _slot_sum(seg, valid, own, terms, num_out).to(dt)


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
                   block_rows: int, w_scale: float = 1.0):
    """The per-CG-iteration positive pass with the fused omega term."""
    if _plain_device(rows):
        return pos_hv_blocked_plain(phi, rows, own, w_blk, dense_mat,
                                    num_out, block_rows, w_scale)
    return kernels.pos_hv_blocked(phi, rows, own, w_blk, dense_mat, num_out,
                                  block_rows, w_scale)


def pos_scatter_blocked(c_blk, rows, own, num_out: int, block_rows: int):
    """The gradient's positive scatter."""
    if _plain_device(rows):
        return pos_scatter_blocked_plain(c_blk, rows, own, num_out,
                                         block_rows)
    return kernels.pos_scatter_blocked(c_blk, rows, own, num_out, block_rows)


def pos_gap_blocked(dP, rows, own, block_rows: int):
    """The residual gap after a step, flat in slot order."""
    if _plain_device(rows):
        return pos_gap_blocked_plain(dP, rows, own, block_rows)
    return kernels.pos_gap_blocked(dP, rows, own, block_rows)


# ---------------------------------------------------------------------------
# fused table-space passes: plain versions
# ---------------------------------------------------------------------------


def _xt_scatter_plain(payload: torch.Tensor, xt: FeatureMajor):
    """(d, k) = X^T payload at the accumulation type, in the kernels'
    order: each chunk's entries in list order, then each feature's chunk
    sums in chunk order."""
    acc = acc_dtype(payload.dtype)
    k = payload.shape[1]
    cptr, fptr = xt.chunk_ptr.long(), xt.feat_ptr.long()
    n_chunks, d = cptr.numel() - 1, fptr.numel() - 1
    part = torch.zeros((max(n_chunks, 1), k), dtype=acc,
                       device=payload.device)
    if n_chunks:
        start, length = cptr[:-1], cptr[1:] - cptr[:-1]
        last = xt.row.numel() - 1
        for j in range(int(length.max())):
            e = (start + j).clamp(max=last)
            term = (xt.val[e].to(acc)[:, None]
                    * payload[xt.row[e].long()].to(acc))
            part = part + torch.where((length > j)[:, None], term, 0)
    out = torch.zeros((d, k), dtype=acc, device=payload.device)
    start, length = fptr[:-1], fptr[1:] - fptr[:-1]
    for j in range(int(length.max()) if d else 0):
        ch = (start + j).clamp(max=part.shape[0] - 1)
        out = out + torch.where((length > j)[:, None], part[ch], 0)
    return out


def pos_hv_tbl_plain(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
                     block_rows: int, w_scale: float = 1.0):
    """X^T [B1 math on phib] with phib = storage(X V): the cross-block Hv of
    a small-D field in table space (pos_hv_tbl_pallas / _kt_pallas)."""
    num = own.shape[0] * block_rows
    zpb = pos_hv_blocked_plain(project_plain(x_idx, x_val, V), rows, own,
                               w_blk, dense_mat, num, block_rows, w_scale)
    return _xt_scatter_plain(zpb, xt)


def grad_cross_tbl_plain(xt, rows, own, c_blk, dense, block_rows: int):
    """X^T storage(dense + storage(blocked scatter of c)): the cross-block
    gradient of a small-D field in table space (grad_cross_tbl_pallas /
    _kt_pallas, without the Jacobi output)."""
    dt, acc = rows.dtype, acc_dtype(rows.dtype)
    zpos = pos_scatter_blocked_plain(c_blk, rows, own, dense.shape[0],
                                     block_rows)
    return _xt_scatter_plain((dense.to(acc) + zpos.to(acc)).to(dt), xt)


def hv_self_tbl_plain(V, x_idx, x_val, xt, Q1, dd):
    """X^T diag(dd <Q1, X V>) Q1 with the storage roundings of phib, the
    dot, s and the payload: the self-block Hv of a small-D field in table
    space (hv_self_tbl_pallas / _kt_pallas)."""
    dt, acc = Q1.dtype, acc_dtype(Q1.dtype)
    q = Q1.to(acc)
    dot = _lane_dot(q, project_plain(x_idx, x_val, V).to(acc))
    s = (dd.to(acc) * dot.to(dt).to(acc)).to(dt).to(acc)
    return _xt_scatter_plain((s[:, None] * q).to(dt), xt)


def grad_self_tbl_plain(xt, Q1, zdense, own, c_blk, block_rows: int):
    """X^T diag(storage(zdense + per-row sums of c)) Q1: the self-block
    gradient of a small-D field in table space (grad_self_tbl_pallas /
    _kt_pallas, without the Jacobi output)."""
    dt, acc = Q1.dtype, acc_dtype(Q1.dtype)
    zb = (zdense.to(acc) + _run_sums(c_blk, own, block_rows)).to(dt)
    return _xt_scatter_plain((zb.to(acc)[:, None] * Q1.to(acc)).to(dt), xt)


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


def scatter_plain(xt: FeatureMajor, Z: torch.Tensor) -> torch.Tensor:
    """G = X^T Z through the field's feature-major list, summed at the
    accumulation type in the X^T stage's order, then cast once to
    storage."""
    return _xt_scatter_plain(Z, xt).to(Z.dtype)


def scatter(xt: FeatureMajor, Z: torch.Tensor) -> torch.Tensor:
    """G = X^T Z of a feature field of any width (the JAX package's
    ``scatter(idx, val, Z, d)``, an XLA segment sum there; ``xt`` holds
    idx, val and d).  Pad rows (val == 0) are not in the list.  On a CUDA
    tensor it runs the X^T stage kernel: per-feature sums in a fixed order,
    no float atomics, so the result is deterministic.  Returns storage, as
    ``scatter_xla`` returns Z's dtype."""
    if _plain_device(Z):
        return scatter_plain(xt, Z)
    return kernels.scatter(xt, Z)


# ---------------------------------------------------------------------------
# fused table-space passes: dispatch (CPU -> plain, CUDA -> kernel).  Each
# returns the (D, k) table-space result at the float32 floor, unrounded.
# ---------------------------------------------------------------------------


def pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
               block_rows: int, w_scale: float = 1.0):
    """The per-CG-iteration cross-block pass of a small-D field."""
    if _plain_device(rows):
        return pos_hv_tbl_plain(V, x_idx, x_val, xt, rows, own, w_blk,
                                dense_mat, block_rows, w_scale)
    return kernels.pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk,
                              dense_mat, block_rows, w_scale)


def grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows: int):
    """The cross-block gradient pass of a small-D field.  Only its X^T side
    reads the field (through ``xt``): the payload is per data row."""
    if _plain_device(rows):
        return grad_cross_tbl_plain(xt, rows, own, c_blk, dense, block_rows)
    return kernels.grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows)


def hv_self_tbl(V, x_idx, x_val, xt, Q1, dd):
    """The per-CG-iteration self-block pass of a small-D field."""
    if _plain_device(Q1):
        return hv_self_tbl_plain(V, x_idx, x_val, xt, Q1, dd)
    return kernels.hv_self_tbl(V, x_idx, x_val, xt, Q1, dd)


def grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows: int):
    """The self-block gradient pass of a small-D field."""
    if _plain_device(Q1):
        return grad_self_tbl_plain(xt, Q1, zdense, own, c_blk, block_rows)
    return kernels.grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows)
