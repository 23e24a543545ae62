"""B10, B1 with G blocks per CTA, on B1's stage loop with one ring across
its G blocks, in the CUDA kernel's order, against
``pos_hv_blocked_g_plain`` (B1's bits).

The kernel (csrc/hv_variants.cu pos_hv_ring_kernel) gives CTA (x, y) the
kRows rows [y * kRows, (y + 1) * kRows) of the blocks x * G ... x * G + G -
1.  Their spans, each widened to whole 8-slot groups, are one sequence of
stages through common.cuh HvSpan's ring of kStages buffers: stage J uses
buffer J % kStages and waits for phase J / kStages of that buffer's
barrier (the parity (J / kStages) & 1), initialised once per CTA.  Thread
0 issues the first kStages stages of the sequence, then the next one,
whichever block it belongs to, each time a stage has been consumed and its
buffer freed.  Each block's phi rows go to one of two phi buffers in turn,
its rows' runs were copied once for all G blocks; each stage
runs phase 1 (every group computes slot dots, whichever rows own them: the
owner by a binary search over the block's runs) and phase 2 (each row's
group adds its slots in slot order), then each row adds its dense term and
is written once.  The plain-load plan (k > 32) has each row add its run
from device memory, block after block.  Here a torch model of that
protocol, written from the kernel's rules, runs on the CPU: every barrier
phase is waited for in issue order, no buffer is refilled before it is
consumed, every valid slot is read once in each phase by the right block's
CTA with the right block's phi and runs, every row is written once, and
the result has the plain version's (B1's) bits for G in {1, 2, 4}."""

import numpy as np
import pytest
import torch
from test_torch_gap_staged import _owner
from test_torch_hv_tree import plan, tree_dot

from one_class_ffm_torch.ops.layout import row_runs
from one_class_ffm_torch.ops.sparse_ops import pos_hv_blocked_g_plain

torch.set_num_threads(1)

K_STAGES = 2  # common.cuh kStages
THREADS = 64  # common.cuh kHvThreads


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(
        torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _n_stages(s: int, e: int, slots: int) -> int:
    return -(-(((e + 7) & ~7) - (s & ~7)) // slots) if s < e else 0


class Ring:
    """The ring of one CTA: kStages buffers, each with a barrier whose
    phases complete in the order their stages were issued."""

    def __init__(self):
        self.buf = [None] * K_STAGES      # (stage J, block g, ws) held
        self.issued = [0] * K_STAGES      # phases issued per barrier
        self.consumed = [0] * K_STAGES    # phases waited for per barrier

    def issue(self, J: int, g: int, ws: int) -> None:
        b = J % K_STAGES
        # the buffer is free: its previous stage was consumed
        assert self.issued[b] == self.consumed[b], (J, self.issued)
        self.buf[b] = (J, g, ws)
        self.issued[b] += 1

    def wait(self, J: int):
        b = J % K_STAGES
        parity = (J // K_STAGES) & 1
        # the phase waited for is the next one issued on this barrier, and
        # its parity is the one the kernel waits on
        assert self.consumed[b] == J // K_STAGES
        assert self.issued[b] == self.consumed[b] + 1, (J, self.issued)
        assert (self.consumed[b] & 1) == parity
        self.consumed[b] += 1
        return self.buf[b]


def ring_hv(phi, rows, w, dmat, runs, bm: int, groups: int, w_scale: float,
            slots: int):
    """B10's output (num, k) at storage dtype, the reads of each slot in
    phases 1 and 2, and the writes of each row."""
    dt, f32 = rows.dtype, torch.float32
    nb, maxc, k = rows.shape
    G, NV, VE = plan(k, rows.element_size())
    staged = VE > 1 and maxc % 8 == 0
    n = THREADS // G  # rows per CTA, one group each
    rows_f, phi_f, dm = rows.to(f32), phi.to(f32), dmat.to(f32)
    w_f = w.to(f32) * torch.tensor(w_scale, dtype=f32)
    out = torch.full((nb * bm, k), float("nan"), dtype=dt)
    reads = np.zeros((2, nb, maxc), np.int64)
    writes = np.zeros(nb * bm, np.int64)
    for x in range(nb // groups):
        for r0 in range(0, bm, n):
            blocks = [x * groups + g for g in range(groups)]
            # the CTA's runs of every block, copied once
            runs_all = [[int(runs[b][min(r0 + i, bm)]) for i in range(n + 1)]
                        for b in blocks]
            ring = Ring()
            # thread 0's cursor over the sequence of stages
            cur = dict(g=0, j=0, J=0)

            def issue_next():
                while (cur["g"] < groups and cur["j"] == _n_stages(
                        runs_all[cur["g"]][0], runs_all[cur["g"]][n],
                        slots)):
                    cur["g"] += 1
                    cur["j"] = 0
                if cur["g"] == groups:
                    return
                s = runs_all[cur["g"]][0]
                ring.issue(cur["J"], cur["g"], (s & ~7) + cur["j"] * slots)
                cur["j"] += 1
                cur["J"] += 1

            if staged:
                for _ in range(K_STAGES):
                    issue_next()
            phi_buf = [None] * 2  # the block whose phi each buffer holds
            J0 = 0
            for g, b in enumerate(blocks):
                live = [r for r in range(r0, r0 + n) if r < bm]
                phi_buf[g % 2] = g
                runs_s = runs_all[g]
                acc = {r: torch.zeros(k, dtype=f32) for r in live}
                if not staged:
                    for r in live:
                        ph = phi_f[b * bm + r][None]
                        for t in range(runs_s[r - r0], runs_s[r - r0 + 1]):
                            dot = tree_dot(ph, rows_f[b, t][None], G, NV,
                                           VE)[0, 0, 0]
                            coef = dot.to(dt).to(f32) * w_f[b, t]
                            acc[r] = acc[r] + coef * rows_f[b, t]
                            reads[:, b, t] += 1
                else:
                    s, e = runs_s[0], runs_s[n]
                    for j in range(_n_stages(s, e, slots)):
                        J = J0 + j
                        Jb, gb, ws = ring.wait(J)
                        assert (Jb, gb) == (J, g)
                        assert ws == (s & ~7) + j * slots
                        assert ws + min(slots, ((e + 7) & ~7) - ws) <= maxc
                        # phase 1: every slot of the CTA's span in the
                        # stage, its owner from this block's runs, its phi
                        # from this block's buffer
                        assert phi_buf[g % 2] == g
                        coef = {}
                        ts = list(range(max(s, ws), min(e, ws + slots)))
                        if ts:
                            own = [r0 + _owner(runs_s, t, n) for t in ts]
                            dots = tree_dot(phi_f[[b * bm + o for o in own]],
                                            rows_f[b, ts], G, NV, VE)[:, 0, 0]
                            for t, dot in zip(ts, dots):
                                coef[t] = dot.to(dt).to(f32) * w_f[b, t]
                                reads[0, b, t] += 1
                        # phase 2: each row's slots in the stage, in order
                        for r in live:
                            for t in range(max(runs_s[r - r0], ws),
                                           min(runs_s[r - r0 + 1],
                                               ws + slots)):
                                acc[r] = acc[r] + coef[t] * rows_f[b, t]
                                reads[1, b, t] += 1
                        issue_next()  # thread 0 refills the freed buffer
                    J0 += _n_stages(s, e, slots)
                for r in live:  # the dense term, i ascending; one write
                    assert phi_buf[g % 2] == g
                    a = acc[r]
                    for i in range(k):
                        a = a + phi_f[b * bm + r, i] * dm[i]
                    out[b * bm + r] = a.to(dt)
                    writes[b * bm + r] += 1
            if staged:  # every issued stage was consumed
                assert cur["J"] == J0 and ring.issued == ring.consumed
    return out, reads, writes


def _stream(rng, k: int, dt, nb: int = 8):
    """Eight blocks of 36 rows (the last slice of a CTA partial): a block
    of pads only, a block whose runs all lie in its first rows (its later
    slices empty), a run of 90 slots beside short ones, short runs with
    empty rows between them, random runs; MAXC a multiple of 8 and of no
    stage of 16 slots or more.  phi holds -0.0, the stream exact zeros."""
    bm = 36
    counts = rng.integers(0, 8, size=(nb, bm))
    counts[1] = 0
    counts[2, 4:] = 0
    counts[3, 5] = 90
    counts[4] = rng.choice([0, 0, 1, 3], size=bm)
    maxc = -(-int(counts.sum(axis=1).max() + 1) // 8) * 8
    if maxc % 16 == 0:
        maxc += 8
    own = np.full((nb, maxc), bm, np.int32)
    for b in range(nb):
        run = np.repeat(np.arange(bm), counts[b])
        own[b, :run.size] = run
    rows = rng.normal(size=(nb, maxc, k))
    rows[rng.random(rows.shape) < 0.2] = 0.0
    phi = rng.normal(size=(nb * bm, k))
    phi[rng.random(phi.shape) < 0.2] = -0.0
    phi[:8] = -0.0
    w = rng.random((nb, maxc)) * (own < bm)
    dmat = rng.normal(size=(k, k)) * 0.1
    T = lambda a: torch.as_tensor(a).to(dt)  # noqa: E731
    return T(phi), T(rows), torch.as_tensor(own), T(w), T(dmat), bm


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("slots", [None, 8, 24])
def test_ring_gives_b1_bits(dt, k, groups, slots):
    """Stages of the kernel's size (about 8 KB) and of 8 and 24 slots
    (stages that cut runs and cross blocks), the vector plans (k = 8, 32)
    and the plain-load plan (k = 40): the ring's
    protocol holds, each valid slot is read once in each phase, each row
    is written once, and the output has pos_hv_blocked_g_plain's bits,
    signs of zero included."""
    rng = np.random.default_rng(90 + k + groups)
    phi, rows, own, w, dmat, bm = _stream(rng, k, dt)
    if slots is None:  # common.cuh stage_slots_for
        slots = max((8192 // (k * rows.element_size())) & ~7, 8)
    runs = row_runs(own.numpy(), bm)
    got, reads, writes = ring_hv(phi, rows, w, dmat, runs, bm, groups, 0.9,
                                 slots)
    num = own.shape[0] * bm
    ref = pos_hv_blocked_g_plain(phi, rows, own, w, dmat, num, bm, groups,
                                 0.9)
    valid = (own < bm).numpy()
    assert (reads[:, valid] == 1).all() and (reads[:, ~valid] == 0).all()
    assert (writes == 1).all()
    assert np.array_equal(_bits(got), _bits(ref)), (k, dt, groups, slots)


def test_ring_crosses_blocks_and_skips_empty_slices():
    """At G = 4 with 8-slot stages, a CTA's stage sequence runs on from one
    block into the next (a block's first stage is issued while the
    previous block's last stages are consumed), and a block whose slice
    holds no slots adds no stage."""
    rng = np.random.default_rng(7)
    phi, rows, own, w, dmat, bm = _stream(rng, 32, torch.float32)
    runs = row_runs(own.numpy(), bm)
    n = THREADS // plan(32, 4)[0]
    seqs = []
    for x in range(2):
        for r0 in range(0, bm, n):
            blocks = range(4 * x, 4 * x + 4)
            seqs.append([_n_stages(int(runs[b][r0]),
                                   int(runs[b][min(r0 + n, bm)]), 8)
                         for b in blocks])
    assert any(0 in s and sum(s) > 0 for s in seqs)  # empty slices inside
    assert any(sum(1 for c in s if c) >= 2 for s in seqs)  # crossings
    got, _, _ = ring_hv(phi, rows, w, dmat, runs, bm, 4, 0.9, 8)
    ref = pos_hv_blocked_g_plain(phi, rows, own, w, dmat,
                                 own.shape[0] * bm, bm, 4, 0.9)
    assert np.array_equal(_bits(got), _bits(ref))
