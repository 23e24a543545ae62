"""B3, the residual gap, in the CUDA kernels' two orders, against
``pos_gap_blocked_plain``.

The staged kernel (csrc/blocked_ops.cu gap_rows_kernel on common.cuh
HvSpan, B1's stage loop without the weight column) gives each CTA kRows
consecutive rows of one block.  The span of their runs, read from the
static row runs and widened to whole 8-slot groups, streams through stages
of ``slots`` slots; every group computes the gaps of batches of a stage's
slots, whichever rows own them (the owner by a binary search over the CTA's
runs), each dot on the group's lane tree (tests/test_torch_hv_tree.py) and
rounded to storage; the stage's gaps are stored in slot order, only those
inside the CTA's own span; the block's last CTA writes the pads' +0.  The
plain-load path (gap_slots_kernel, a warp per slot) starts each lane sum at
-0, the identity of the sum.  Here torch models of both, written from those
rules, run on the CPU: every slot must be written exactly once, and the
gaps must have the plain version's bits at float32 and bfloat16, signs of
zero included."""

import numpy as np
import pytest
import torch
from test_torch_hv_tree import plan, tree_dot

from one_class_ffm_torch.ops.layout import row_runs
from one_class_ffm_torch.ops.sparse_ops import _lane_dot, pos_gap_blocked_plain

torch.set_num_threads(1)

K_MAX_PER_LANE = 8  # common.cuh kMaxKPerLane


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _owner(runs_s, t: int, n: int) -> int:
    """The CTA row owning slot t: hv_stage_dots' search for the last g with
    runs_s[g] <= t, in steps of n / 2, n / 4, ... (n a power of two)."""
    g, step = 0, n // 2
    while step:
        if runs_s[g + step] <= t:
            g += step
        step //= 2
    return g


def staged_gap(dP, rows, runs, bm: int, threads: int, slots: int):
    """The staged kernel's gaps (n_blocks * MAXC,) at storage dtype, and the
    number of times each slot was written."""
    dt, f32 = rows.dtype, torch.float32
    nb, maxc, k = rows.shape
    G, NV, VE = plan(k, rows.element_size())
    assert NV == 1 and maxc % 8 == 0 and slots % 8 == 0
    n = threads // G  # rows per CTA, one group each
    out = torch.full((nb, maxc), float("nan"), dtype=dt)
    writes = np.zeros((nb, maxc), np.int64)
    for b in range(nb):
        rb = [int(x) for x in runs[b]]
        for r0 in range(0, bm, n):
            s, e = rb[r0], rb[min(r0 + n, bm)]
            runs_s = [rb[min(r0 + i, bm)] for i in range(n + 1)]
            w0, w1 = s & ~7, (e + 7) & ~7
            n_st = -(-(w1 - w0) // slots) if s < e else 0
            for j in range(n_st):
                ws = w0 + j * slots
                ts = list(range(max(s, ws), min(e, ws + slots)))
                if not ts:
                    continue
                owners = [b * bm + r0 + _owner(runs_s, t, n) for t in ts]
                dots = tree_dot(dP[owners].to(f32), rows[b, ts].to(f32), G,
                                NV, VE)[:, 0, 0]
                out[b, ts] = dots.to(dt)
                writes[b, ts] += 1
            if r0 + n >= bm:  # the block's last CTA: the pads
                out[b, e:] = 0.0
                writes[b, e:] += 1
    return out.reshape(-1), writes


def _stream(rng, k: int, dt):
    """Four blocks of 32 rows: short runs with empty rows between them, a
    block of pads only, a run of 90 slots beside short ones, random runs;
    MAXC a multiple of 8 and of no stage of 16 slots or more; dP holding
    -0.0 (rows 0-7 all of it, against slots without negative values) and
    the stream exact zeros."""
    bm = 32
    counts = np.zeros((4, bm), np.int64)
    counts[0] = rng.choice([0, 0, 1, 3], size=bm)
    counts[2] = rng.integers(0, 3, size=bm)
    counts[2, 5] = 90
    counts[3] = rng.integers(0, 12, size=bm)
    maxc = -(-int(counts.sum(axis=1).max() + 1) // 8) * 8
    if maxc % 16 == 0:  # no multiple of a stage of 16 slots or more
        maxc += 8
    own = np.full((4, maxc), bm, np.int32)
    for b in range(4):
        run = np.repeat(np.arange(bm), counts[b])
        own[b, :run.size] = run
    rows = rng.normal(size=(4, maxc, k))
    rows[rng.random(rows.shape) < 0.2] = 0.0
    n0 = int(counts[0, :8].sum())  # rows 0-7's slots: every product -0
    rows[0, :n0] = np.abs(rows[0, :n0])
    dP = rng.normal(size=(4 * bm, k))
    dP[rng.random(dP.shape) < 0.2] = -0.0
    dP[:8] = -0.0
    return (torch.as_tensor(dP).to(dt), torch.as_tensor(rows).to(dt),
            torch.as_tensor(own), bm)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("threads, slots", [(64, None), (64, 8), (256, 24)])
def test_staged_gap_gives_plain_bits(dt, k, threads, slots):
    """Stages of the kernel's size (about 8 KB of the stream) and of 8 and
    24 slots (stages that cut runs, and a MAXC that is no multiple of the
    stage), CTAs of 64 and 256 threads: each slot written once, the gaps
    with pos_gap_blocked_plain's bits, every pad +0."""
    rng = np.random.default_rng(40 + k)
    dP, rows, own, bm = _stream(rng, k, dt)
    if slots is None:  # common.cuh stage_slots_for
        slots = max((8192 // (k * rows.element_size())) & ~7, 8)
    if slots % 16 == 0:  # the last stage of the pads-only MAXC is short
        assert own.shape[1] % slots
    runs = row_runs(own.numpy(), bm)
    got, writes = staged_gap(dP, rows, runs, bm, threads, slots)
    ref = pos_gap_blocked_plain(dP, rows, own, bm)
    assert (writes == 1).all()
    assert ref.dtype == dt and got.shape == ref.shape
    assert np.array_equal(_bits(got), _bits(ref)), (k, dt, threads, slots)
    pads = (own == bm).reshape(-1)
    assert not torch.any(torch.signbit(got[pads]))
    assert torch.all(got.view(own.shape)[1] == 0)  # the block of pads only
    # rows 0-7's gaps: -0 where k fills the 32 lanes, +0 where padding adds
    neg_zero = torch.signbit(ref) & (ref == 0)
    assert bool(torch.any(neg_zero)) == (k == 32)


def slot_gap(dP_row, row, dt):
    """gap_slots_kernel's dot of one slot: lane l's sum starts at -0 and
    adds the products of columns l, l + 32, ... for each of the ceil(k / 32)
    column groups, +0 for a column past k; then the butterfly (warp_sum);
    rounded to storage."""
    k = row.shape[0]
    lanes = []
    for lane in range(32):
        x = torch.tensor(-0.0, dtype=torch.float32)
        for j in range(K_MAX_PER_LANE):
            c = j * 32 + lane
            if j * 32 < k:
                x = x + (dP_row[c] * row[c] if c < k
                         else torch.tensor(0.0, dtype=torch.float32))
        lanes.append(x)
    lane = torch.stack(lanes)
    ids = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lane = lane + lane[ids ^ off]
    return lane[0].to(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [12, 40, 64])
def test_plain_load_gap_gives_lane_dot_bits(dt, k):
    """The warp-per-slot path's lane sums (starting at -0) give _lane_dot's
    bits on rows whose every product is -0 (the sum is -0 where k fills
    whole lanes, +0 where a padded column adds +0), on rows of zeros of
    both signs and on random rows; its pads are +0 as the plain's."""
    rng = np.random.default_rng(50 + k)
    n = 40
    a = rng.normal(size=(n, k)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    a[:8], b[:8] = -0.0, np.abs(b[:8])  # every product -0
    a[8:16, ::2], b[8:16, 1::2] = -0.0, 0.0
    a[rng.random((n, k)) < 0.2] = -0.0
    a = torch.from_numpy(a).to(dt).to(torch.float32)
    b = torch.from_numpy(b).to(dt).to(torch.float32)
    got = torch.stack([slot_gap(a[i], b[i], dt) for i in range(n)])
    ref = _lane_dot(a, b).to(dt)
    assert np.array_equal(_bits(got), _bits(ref)), (k, dt)
    assert bool(torch.all(torch.signbit(ref[:8]))) == (k % 32 == 0)
    # through the plain version: one block, every slot owned by row 0
    own = torch.zeros((1, n + 8), dtype=torch.int32)
    own[0, n:] = 1
    rows = torch.cat([b, torch.ones(8, k)]).to(dt)[None]
    for i in (0, 9, 20):
        gap = pos_gap_blocked_plain(a[i:i + 1].to(dt), rows, own, 1)
        want = torch.stack([slot_gap(a[i], b[t], dt) for t in range(n)])
        assert np.array_equal(_bits(gap[:n]), _bits(want)), (k, dt, i)
        assert not torch.any(torch.signbit(gap[n:])) and torch.all(
            gap[n:] == 0)
