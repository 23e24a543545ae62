"""B9, B1's function read from the lane-packed stream, on B1's stage loop
with tensor-map copies, in the CUDA kernel's order, against
``pos_hv_packed_plain`` and ``pos_hv_blocked_plain`` (B1's bits).

The kernel (csrc/hv_variants.cu pos_hv_packed_kernel: common.cuh hv_rows
and HvSpan on the stream layout PackedStream) gives CTA (b, y) the kRows
rows [y * kRows, (y + 1) * kRows) of block b; their span of slots [s, e)
comes from the static runs.  The packed stream puts slot e = j * m4 + c
(m4 = MAXC / 4) at row c, lanes 32j..32j+31, its weight copied to all 32
lanes.  Stage j of the span starts at s + j * slots while it stays in s's
lane group, then at the start of each later group the span reaches and
every ``slots`` slots after it; it ends at the earlier of ``slots`` slots
on, its group's end and the span's end.  Thread 0 fills a stage with one
box of ``slots`` rows from each of two 3-D tensor maps {128, m4,
n_blocks}: 32 values of each row (the stage's rows, row-major), and the
first 16 bytes of each row of the weights (the slot's weight first, so the
weights sit 16 / sizeof(T) elements apart); box rows past m4 are
zeros.  Each stage runs
phase 1 (every group computes slot dots, whichever rows own them) and
phase 2 (each row's group adds its slots in slot order), then each row adds
its dense term and is written once.  Here a torch model of those rules
runs on the CPU: windows never cross a multiple of m4, boxes stay inside
their block and rows past m4 are zero-filled, no box row past its stage's
slots is used, every valid slot is read once in each phase, weights are
read at their stride, every row is written once, and the result has B1's
bits at float32 and bfloat16."""

import numpy as np
import pytest
import torch
from test_torch_gap_staged import _owner
from test_torch_hv_tree import plan, tree_dot

from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops.layout import row_runs
from one_class_ffm_torch.ops.sparse_ops import (
    pack_rows,
    pos_hv_blocked_plain,
    pos_hv_packed_plain,
)

torch.set_num_threads(1)

K = 32        # the packed layout's k (hv_variants.cu kPackedK)
SLOTS = 64    # slots per stage and rows per box (hv_variants.cu kPackedSlots)
THREADS = 64  # common.cuh kHvThreads
BM = 24       # rows per block here: the last CTA of a block partial at bf16
W_SCALE = 0.9


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# PackedStream's stage walk, closed form as the kernel computes it

def group_end(t: int, m4: int) -> int:
    return (t // m4 + 1) * m4


def n_stages(s: int, e: int, m4: int, slots: int) -> int:
    if s >= e:
        return 0
    b0 = group_end(s, m4)
    n0 = _cdiv(min(e, b0) - s, slots)
    if e <= b0:
        return n0
    rest = e - b0
    return n0 + rest // m4 * _cdiv(m4, slots) + _cdiv(rest % m4, slots)


def stage_start(j: int, s: int, e: int, m4: int, slots: int) -> int:
    b0 = group_end(s, m4)
    n0 = _cdiv(min(e, b0) - s, slots)
    if j < n0:
        return s + j * slots
    per, q = _cdiv(m4, slots), j - n0
    return b0 + q // per * m4 + q % per * slots


def stage_stop(ws: int, m4: int, slots: int) -> int:
    return min(ws + slots, group_end(ws, m4))


def fill(rows_p, w_p, b: int, ws: int, e: int, slots: int):
    """A stage's buffers as thread 0's two box copies leave them: (slots,
    32) rows and slots * WS weights (float32), and the number of slots of
    the stage."""
    m4 = rows_p.shape[1]
    ws_stride = 16 // rows_p.element_size()
    j, c = divmod(ws, m4)
    n = min(e, stage_stop(ws, m4, slots)) - ws
    assert 0 < n <= slots
    assert (ws + n - 1) // m4 == j  # the stage stays in its lane group
    buf = torch.empty((slots, K))
    buf_w = torch.empty((slots * ws_stride,))
    for o in range(slots):  # buffer row o: the map's row c + o
        row = c + o
        if row < m4:  # the map's second extent is m4: block b only
            buf[o] = rows_p[b, row, 32 * j:32 * j + K].float()
            buf_w[o * ws_stride:(o + 1) * ws_stride] = \
                w_p[b, row, 32 * j:32 * j + ws_stride].float()
        else:  # past the group: the box's zero fill
            buf[o] = 0.0
            buf_w[o * ws_stride:(o + 1) * ws_stride] = 0.0
    return buf, buf_w, n


def packed_hv(phi, rows_p, w_p, dmat, runs, bm: int, w_scale: float,
              slots: int):
    """B9's output (num, k) at storage dtype, the reads of each slot (in
    slot order e = j * m4 + c) in phases 1 and 2, the writes of each row,
    and the lane-group crossings of each CTA's span."""
    dt, f32 = rows_p.dtype, torch.float32
    nb, m4, _ = rows_p.shape
    maxc = 4 * m4
    G, NV, VE = plan(K, rows_p.element_size())
    ws_stride = 16 // rows_p.element_size()
    n = THREADS // G  # rows per CTA, one group each
    phi_f, dm = phi.to(f32), dmat.to(f32)
    scale = torch.tensor(w_scale, dtype=f32)
    out = torch.full((nb * bm, K), float("nan"), dtype=dt)
    reads = np.zeros((2, nb, maxc), np.int64)
    writes = np.zeros(nb * bm, np.int64)
    crossings = []
    for b in range(nb):
        for r0 in range(0, bm, n):
            runs_s = [int(runs[b][min(r0 + i, bm)]) for i in range(n + 1)]
            s, e = runs_s[0], runs_s[n]
            if s < e:
                crossings.append((e - 1) // m4 - s // m4)
            live = [r for r in range(r0, r0 + n) if r < bm]
            acc = {r: torch.zeros(K, dtype=f32) for r in live}
            for j in range(n_stages(s, e, m4, slots)):
                ws = stage_start(j, s, e, m4, slots)
                lo, hi = max(s, ws), min(e, stage_stop(ws, m4, slots))
                assert lo == ws and lo < hi
                buf, buf_w, n_in = fill(rows_p, w_p, b, ws, e, slots)
                # phase 1: every slot of the stage, the weight at its stride
                coef = {}
                ts = list(range(lo, hi))
                assert all(t - ws < n_in for t in ts)  # no row past the stage
                own = [r0 + _owner(runs_s, t, n) for t in ts]
                dots = tree_dot(phi_f[[b * bm + o for o in own]],
                                buf[[t - ws for t in ts]], G, NV, VE)[:, 0, 0]
                for t, dot in zip(ts, dots):
                    wt = scale * buf_w[(t - ws) * ws_stride]
                    coef[t] = dot.to(dt).to(f32) * wt
                    reads[0, b, t] += 1
                # phase 2: each row's slots in the stage, in order
                for r in live:
                    for t in range(max(runs_s[r - r0], ws),
                                   min(runs_s[r - r0 + 1],
                                       stage_stop(ws, m4, slots))):
                        acc[r] = acc[r] + coef[t] * buf[t - ws]
                        reads[1, b, t] += 1
            for r in live:  # the dense term, i ascending; one write
                a = acc[r]
                for i in range(K):
                    a = a + phi_f[b * bm + r, i] * dm[i]
                out[b * bm + r] = a.to(dt)
                writes[b * bm + r] += 1
    return out, reads, writes, crossings


def packed_stream(rng, maxc: int, dt, bm: int = BM):
    """Six blocks of ``bm`` rows in slot order: a block of pads only, a
    block whose runs all lie in its first rows (its later slices empty), a
    run that crosses three lane-group boundaries (3 * MAXC/4 slots, after
    3 slots), short runs with empty rows between them, long random runs
    (spans over one or two groups), and a span that crosses two boundaries
    (MAXC/8 slots, then 2 * MAXC/4), then sparse rows.  phi holds -0.0, the stream
    exact zeros.  Returns the unpacked (phi, rows, own, w, dmat) and the
    packed (rows_p, own_p, w_p)."""
    m4, cap = maxc // 4, maxc - 1
    counts = np.zeros((6, bm), np.int64)
    counts[1, :4] = rng.integers(0, 4, size=4)
    counts[2, 0], counts[2, 1] = 3, min(3 * m4, cap - 3)
    counts[3] = rng.choice([0, 0, 1, 3], size=bm)
    counts[4] = rng.integers(0, max(2, 2 * maxc // bm), size=bm)
    counts[5, 0], counts[5, 1] = m4 // 2, 2 * m4
    counts[5, 8:] = rng.choice([0, 0, 0, 1], size=bm - 8)
    own = np.full((6, maxc), bm, np.int32)
    for b in range(6):
        if counts[b].sum() > cap:
            counts[b] = counts[b] * cap // counts[b].sum()
        run = np.repeat(np.arange(bm), counts[b])
        own[b, :run.size] = run
    rows = rng.normal(size=(6, maxc, K))
    rows[rng.random(rows.shape) < 0.2] = 0.0
    phi = rng.normal(size=(6 * bm, K))
    phi[rng.random(phi.shape) < 0.2] = -0.0
    phi[:8] = -0.0
    w = rng.random((6, maxc)) * (own < bm)
    dmat = rng.normal(size=(K, K)) * 0.1
    T = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
    unpacked = (T(phi), T(rows), torch.as_tensor(own), T(w), T(dmat))
    return unpacked, pack_rows(unpacked[1], unpacked[2], unpacked[3])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxc", [64, 40, 1240])
@pytest.mark.parametrize("slots", [None, 8, 24])
def test_packed_stages_give_b1_bits(dt, maxc, slots):
    """MAXC/4 a multiple of 8 (64: 16) and not (40: 10; 1240: 310, MF's u
    stream), stages of the kernel's 64 slots and of 8 and 24 slots: windows stay in their lane group, every valid slot is read once
    in each phase and pads never, every row is written once, and the output
    has pos_hv_packed_plain's and pos_hv_blocked_plain's bits, signs of
    zero included."""
    rng = np.random.default_rng(100 + maxc)
    (phi, rows, own, w, dmat), (rows_p, own_p, w_p) = packed_stream(
        rng, maxc, dt)
    slots = slots or SLOTS
    runs = row_runs(own.numpy(), BM)
    got, reads, writes, _ = packed_hv(phi, rows_p, w_p, dmat, runs, BM,
                                      W_SCALE, slots)
    num = own.shape[0] * BM
    ref = pos_hv_packed_plain(phi, rows_p, own_p, w_p, dmat, num, BM,
                              W_SCALE)
    b1 = pos_hv_blocked_plain(phi, rows, own, w, dmat, num, BM, W_SCALE)
    valid = (own < BM).numpy()
    assert (reads[:, valid] == 1).all() and (reads[:, ~valid] == 0).all()
    assert (writes == 1).all()
    assert np.array_equal(_bits(got), _bits(ref)), (maxc, dt, slots)
    assert np.array_equal(_bits(got), _bits(b1)), (maxc, dt, slots)


@pytest.mark.parametrize("maxc", [64, 40, 1240])
def test_spans_cross_zero_to_three_groups_and_slices_are_empty(maxc):
    """The streams above give CTA spans that cross 0, 1, 2 and 3 lane-group
    boundaries, and CTAs whose rows hold no slot (no stage)."""
    rng = np.random.default_rng(100 + maxc)
    (_, _, own, _, _), (rows_p, _, w_p) = packed_stream(rng, maxc,
                                                        torch.float32)
    runs = row_runs(own.numpy(), BM)
    n = THREADS // plan(K, 4)[0]
    empty = sum(int(runs[b][r0]) == int(runs[b][min(r0 + n, BM)])
                for b in range(runs.shape[0]) for r0 in range(0, BM, n))
    _, _, _, crossings = packed_hv(*[torch.zeros(6 * BM, K), rows_p, w_p,
                                     torch.zeros(K, K)], runs, BM, W_SCALE,
                                   24)
    assert set(crossings) >= {0, 1, 2, 3}, crossings
    assert empty > 0


def test_stage_walk_closed_form_matches_the_walk():
    """PackedStream's closed forms (stages, start) against the walk they
    stand for: from s, a stage of min(slots, to the group's end) slots at a
    time, on random spans, MAXC/4 and stage sizes."""
    rng = np.random.default_rng(3)
    for _ in range(2000):
        m4 = int(rng.integers(1, 400))
        slots = int(rng.choice([8, 16, 24, 32, 64, 128]))
        s = int(rng.integers(0, 4 * m4))
        e = int(rng.integers(s, 4 * m4 + 1))
        walk, ws = [], s
        while ws < e:
            walk.append(ws)
            ws = min(e, stage_stop(ws, m4, slots))
        assert n_stages(s, e, m4, slots) == len(walk), (m4, slots, s, e)
        assert [stage_start(j, s, e, m4, slots)
                for j in range(len(walk))] == walk, (m4, slots, s, e)


@pytest.mark.parametrize("maxc", [64, 40, 1240])
def test_wrapper_runs_from_packed_owners_are_the_row_runs(maxc):
    """Without ``runs`` the wrapper finds them on the device from the
    owners in lane 0 of each group (``kernels._packed_runs``): they are
    ``layout.row_runs`` of the unpacked owners."""
    rng = np.random.default_rng(200 + maxc)
    (_, _, own, _, _), (_, own_p, _) = packed_stream(rng, maxc,
                                                     torch.float32)
    got = kernels._packed_runs(own_p, BM)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), row_runs(own.numpy(), BM))
