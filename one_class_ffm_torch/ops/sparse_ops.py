"""Sparse ops of the MF slice: plain PyTorch versions and kernel dispatch.

Counterparts of ``one_class_ffm_tpu/ops/sparse_ops.py``.  The pre-gathered
stream is row-major, ``(n_blocks, MAXC, k)``: the k-major ("kt") layout of
the JAX package only worked around TPU lane padding of k < 128.

The three blocked passes (``pos_hv_blocked``, ``pos_scatter_blocked``,
``pos_gap_blocked``) each have a plain version here (``*_plain``) and a
hand-written CUDA kernel (csrc/blocked_ops.cu via ops/kernels.py).  The
dispatching function takes the plain version only because its tensors lie
on the CPU; on a CUDA tensor it launches the kernel or raises.  Storage is
float32 or bfloat16 (float64 on the CPU), sums run at a float32 floor, and
the plain versions round where the kernels round: pq to storage, the output
to storage.

The plain versions also add in the kernels' order, one rounding per
product and per sum (the kernels use no fused multiply-add): a k-long dot
is 32 lane sums folded by an xor butterfly, a row's slots are added in slot
order, then the dense term in column order.  At float32 and bfloat16 the
kernel and its plain version therefore agree bit for bit; a looser bound
would let a one-ulp flip of a bfloat16 pq or output, which different sum
orders do cause, pass for a kernel fault or hide one.
"""

from __future__ import annotations

import torch

from . import kernels

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


def project(idx: torch.Tensor, val: torch.Tensor,
            W: torch.Tensor) -> torch.Tensor:
    """P[i] = sum_s val[i, s] * W[idx[i, s]] (``project_xla``)."""
    out = val[:, 0, None] * W[idx[:, 0].long()]
    for s in range(1, idx.shape[1]):
        out = out + val[:, s, None] * W[idx[:, s].long()]
    return out


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
