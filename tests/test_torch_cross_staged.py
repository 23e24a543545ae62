"""B5's row stage on B2's runs-and-stages body, in the CUDA kernel's order,
against ``grad_cross_tbl_plain``.

The kernel (csrc/blocked_ops.cu grad_cross_rows_kernel, B2's
``scatter_rows`` with the dense term) gives each CTA kRows consecutive rows
of one block, a group of G lanes per row.  The span of their runs, read
from the static row runs and widened to whole 8-slot groups, streams
through stages of ``slots`` slots; each row's group adds the slots of its
own run that lie in the stage, in slot order, c_t * rows_t at float32 from
+0 (and, for the Jacobi payload, storage(w_t * storage(wq_scale)) *
storage(rows_t^2), unrounded); after the stage loop each live row writes
storage(dense[r] + storage(sum)) once, and its Jacobi payload
storage(sum_q).  The plain-load plan (k * element size % 16 != 0, or MAXC %
8 != 0) adds each row's run from device memory in the same order.  Here a
torch model of both, written from those rules, runs on the CPU: every
valid slot must be added exactly once, by its own row, every row written
exactly once, and the payloads (and their X^T) must have the plain
version's bits at float32 and bfloat16, signs of zero included."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops.layout import FeatureMajor, feature_major, row_runs
from one_class_ffm_torch.ops.sparse_ops import (
    _xt_scatter_plain,
    grad_cross_payload_plain,
    grad_cross_tbl_plain,
)

torch.set_num_threads(1)

K_MAX_PER_LANE = 8  # common.cuh kMaxKPerLane


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def scatter_plan(k: int, elem_bytes: int, maxc: int):
    """(G, NV, VE) as common.cuh by_width picks it for B2 and B5's row
    stage: 16-byte vectors (the smallest power-of-two group covering k,
    NV = 2 past 32 vectors) where rows are whole vectors and MAXC % 8 ==
    0, else the plain-load plan."""
    ve = 16 // elem_bytes
    if (k * elem_bytes) % 16 or maxc % 8:
        return 32, K_MAX_PER_LANE, 1
    n = k // ve
    if n > 32:
        return 32, 2, ve
    g = 1
    while g < n:
        g *= 2
    return g, 1, ve


def _storage(x: torch.Tensor, dt) -> torch.Tensor:
    return x.to(dt).to(torch.float32)


def staged_rows(c, rows, runs, dense, bm: int, threads: int, slots: int,
                w=None, wq_scale: float = 1.0):
    """The kernel's payloads (num, k) at storage dtype (and the Jacobi
    payload with ``w``), the times each slot was added and each row
    written."""
    dt, f32 = rows.dtype, torch.float32
    nb, maxc, k = rows.shape
    G, NV, VE = scatter_plan(k, rows.element_size(), maxc)
    staged = VE > 1
    n = threads // G  # rows per CTA, one group each
    rows_f, c_f = rows.to(f32), c.to(f32)
    wq = _storage(torch.tensor(wq_scale), dt)
    out = torch.full((nb * bm, k), float("nan"), dtype=dt)
    outq = torch.full((nb * bm, k), float("nan"), dtype=dt)
    adds = np.zeros((nb, maxc), np.int64)
    writes = np.zeros(nb * bm, np.int64)
    for b in range(nb):
        rb = [int(x) for x in runs[b]]
        for r0 in range(0, bm, n):
            live = [r for r in range(r0, r0 + n) if r < bm]
            acc = {r: torch.zeros(k, dtype=f32) for r in live}
            accq = {r: torch.zeros(k, dtype=f32) for r in live}

            def add(r, t):
                acc[r] = acc[r] + c_f[b, t] * rows_f[b, t]
                if w is not None:
                    wt = _storage(w[b, t].to(f32) * wq, dt)
                    accq[r] = accq[r] + wt * _storage(
                        rows_f[b, t] * rows_f[b, t], dt)
                adds[b, t] += 1

            if staged:
                s, e = rb[r0], rb[min(r0 + n, bm)]
                w0, w1 = s & ~7, (e + 7) & ~7
                n_st = -(-(w1 - w0) // slots) if s < e else 0
                for j in range(n_st):
                    ws = w0 + j * slots
                    cnt = min(slots, w1 - ws)  # the bulk copy's slots
                    assert cnt > 0 and cnt % 8 == 0 and ws + cnt <= maxc
                    for r in live:
                        for t in range(max(rb[r], ws),
                                       min(rb[r + 1], ws + slots)):
                            add(r, t)
            else:
                for r in live:
                    for t in range(rb[r], rb[r + 1]):
                        add(r, t)
            for r in live:
                row = b * bm + r
                out[row] = (dense[row].to(f32) + _storage(acc[r], dt)).to(dt)
                outq[row] = accq[r].to(dt)
                writes[row] += 1
    return out, (outq if w is not None else None), adds, writes


def _stream(rng, k: int, dt, maxc_pad: int):
    """Four blocks of 36 rows: short runs with empty rows between them, a
    block of pads only, a run of 90 slots beside short ones, random runs;
    MAXC a multiple of 8 plus ``maxc_pad`` (3: the plain-load plan), and a
    multiple of no stage of 16 slots or more.  The coefficients and the
    dense rows hold -0.0 (row 0's sum is +0 + -0 products, its dense -0),
    the stream exact zeros."""
    bm = 36
    counts = np.zeros((4, bm), np.int64)
    counts[0] = rng.choice([0, 0, 1, 3], size=bm)
    counts[0, 0] = 2
    counts[2] = rng.integers(0, 3, size=bm)
    counts[2, 5] = 90
    counts[3] = rng.integers(0, 12, size=bm)
    maxc = -(-int(counts.sum(axis=1).max() + 1) // 8) * 8
    if maxc % 16 == 0:
        maxc += 8
    maxc += maxc_pad
    own = np.full((4, maxc), bm, np.int32)
    for b in range(4):
        run = np.repeat(np.arange(bm), counts[b])
        own[b, :run.size] = run
    valid = own < bm
    rows = rng.normal(size=(4, maxc, k))
    rows[rng.random(rows.shape) < 0.2] = 0.0
    c = rng.normal(size=(4, maxc)) * valid
    c[rng.random(c.shape) < 0.1] = -0.0
    c[0, :2] = -0.0  # row 0 of block 0: two -0 coefficients
    w = rng.random((4, maxc)) * valid
    dense = rng.normal(size=(4 * bm, k))
    dense[rng.random(dense.shape) < 0.2] = -0.0
    dense[0] = -0.0
    T = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
    return (T(c), T(rows), torch.as_tensor(own), T(dense), T(w), bm)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 12, 32, 48])
@pytest.mark.parametrize("slots", [None, 8, 24])
@pytest.mark.parametrize("threads", [64, 256])
def test_staged_cross_rows_give_plain_bits(dt, k, slots, threads):
    """Stages of the kernel's size (about 8 KB of the stream) and of 8 and
    24 slots (stages that cut runs), CTAs of 64 threads (the kernel's) and
    256, k on the vector plans and (12 at bfloat16) the plain-load plan:
    each valid slot added once, each row written once, the payload and the
    Jacobi payload with grad_cross_tbl_plain's bits, and so its X^T."""
    rng = np.random.default_rng(60 + k)
    c, rows, own, dense, w, bm = _stream(rng, k, dt, 0)
    if slots is None:  # common.cuh stage_slots_for
        slots = max((8192 // (k * rows.element_size())) & ~7, 8)
    runs = row_runs(own.numpy(), bm)
    got, gotq, adds, writes = staged_rows(c, rows, runs, dense, bm, threads,
                                          slots, w=w, wq_scale=0.9)
    ref, refq = grad_cross_payload_plain(rows, own, c, dense, bm, w, 0.9)
    valid = (own < bm).numpy()
    assert (adds[valid] == 1).all() and (adds[~valid] == 0).all()
    assert (writes == 1).all()
    assert np.array_equal(_bits(got), _bits(ref)), (k, dt, threads, slots)
    assert np.array_equal(_bits(gotq), _bits(refq)), (k, dt, threads, slots)
    # the payload without the Jacobi output is the same
    alone, _, _, _ = staged_rows(c, rows, runs, dense, bm, threads, slots)
    assert np.array_equal(_bits(alone), _bits(ref))
    # row 0 of block 0: dense -0 + storage(+0 + -0 + -0) is +0
    assert not torch.signbit(got[0]).any() and torch.all(got[0] == 0)
    # the block of pads only: its rows are storage(dense + 0), Jacobi +0
    blk1 = slice(bm, 2 * bm)
    assert np.array_equal(_bits(got[blk1]),
                          _bits((dense[blk1].float() + 0.0).to(dt)))
    assert torch.all(gotq[blk1] == 0) and not torch.signbit(gotq[blk1]).any()
    # through the X^T stage: grad_cross_tbl_plain's table-space bits
    d = 7
    idx = rng.integers(0, d, size=(own.shape[0] * bm, 2)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=idx.shape)
    fm = feature_major(idx, val, d)
    v = torch.as_tensor(fm.val).to(dt)
    xt = FeatureMajor(row=torch.as_tensor(fm.row), val=v,
                      chunk_ptr=torch.as_tensor(fm.chunk_ptr),
                      feat_ptr=torch.as_tensor(fm.feat_ptr), n_rows=fm.n_rows,
                      val_sq=v * v)
    gt, qt = grad_cross_tbl_plain(xt, rows, own, c, dense, bm, w, 0.9)
    assert np.array_equal(_bits(_xt_scatter_plain(got, xt)), _bits(gt))
    assert np.array_equal(_bits(_xt_scatter_plain(gotq, xt, True)),
                          _bits(qt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32])
def test_plain_load_cross_rows_give_plain_bits(dt, k):
    """MAXC % 8 != 0 takes the plain-load plan (each row's run read from
    device memory, no stages): the same adds, the same bits."""
    rng = np.random.default_rng(70 + k)
    c, rows, own, dense, w, bm = _stream(rng, k, dt, 3)
    assert scatter_plan(k, rows.element_size(), own.shape[1])[2] == 1
    runs = row_runs(own.numpy(), bm)
    got, gotq, adds, writes = staged_rows(c, rows, runs, dense, bm, 64, 8,
                                          w=w, wq_scale=0.9)
    ref, refq = grad_cross_payload_plain(rows, own, c, dense, bm, w, 0.9)
    valid = (own < bm).numpy()
    assert (adds[valid] == 1).all() and (writes == 1).all()
    assert np.array_equal(_bits(got), _bits(ref))
    assert np.array_equal(_bits(gotq), _bits(refq))


def test_jacobi_payload_is_summed_unrounded():
    """B5's Jacobi payload sums wq_t * storage(rows_t^2) at float32 (its TPU
    kernel's one-hot matmul), where B2's rounds each term to storage first:
    at bfloat16 the two differ, and the model follows B5's plain version."""
    from one_class_ffm_torch.ops.sparse_ops import pos_scatter_blocked_plain

    rng = np.random.default_rng(80)
    c, rows, own, dense, w, bm = _stream(rng, 32, torch.bfloat16, 0)
    runs = row_runs(own.numpy(), bm)
    _, gotq, _, _ = staged_rows(c, rows, runs, dense, bm, 64, 64, w=w,
                                wq_scale=0.9)
    _, b2q = pos_scatter_blocked_plain(c, rows, own, dense.shape[0], bm, w,
                                       0.9)
    _, refq = grad_cross_payload_plain(rows, own, c, dense, bm, w, 0.9)
    assert np.array_equal(_bits(gotq), _bits(refq))
    assert not np.array_equal(_bits(gotq), _bits(b2q))
