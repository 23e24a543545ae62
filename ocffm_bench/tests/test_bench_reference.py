"""The plain reference against the port's plain CPU path at a tiny size,
through the train and rank runners' own runs; and the faults of a run that the
comparison has to catch, each planted under the timed path."""

import numpy as np
import pytest
import torch

from ocffm_bench import gen, harness
from ocffm_bench.reference.ffm_ref import (Reference, init_tables,
                                          start_tables, table_dims)
from ocffm_bench.tests.common import tiny_context

TRAIN = ["kkbox-ffm-k64.train-skew", "kkbox-mf-k32.train-uniform"]
RANK = "kkbox-ffm-k64.rank-b1024"


def run(ctx):
    res = harness.run_driver(ctx)
    return res, all(c.ok for c in res.checks) and res.failed == 0


@pytest.mark.parametrize("workload", TRAIN)
def test_program_matches_reference(workload):
    res, ok = run(tiny_context(workload))
    assert ok, harness.check_lines(res)
    assert res.attempted >= 1 and res.run["epochs"] >= 3
    assert res.end_to_end["train_examples_per_s"] > 0


def test_rank_matches_reference():
    res, ok = run(tiny_context(RANK))
    assert ok, harness.check_lines(res)
    assert res.attempted == res.run["requests"] > 0


def _unchanged(solver):
    def epoch_stats(state):
        return state, torch.zeros(len(solver.blocks) * 2, dtype=torch.int32)
    solver.epoch_stats = epoch_stats


def _half_positives(problem):
    keep = np.arange(problem.pos_u.shape[0]) % 2 == 0
    return gen.Problem(problem.users, problem.items, problem.pos_u[keep],
                       problem.pos_v[keep], problem.popular,
                       problem.user_label, problem.item_label)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_positives"])
def test_train_fault_fails(workload, fault):
    hooks = ({"solver": _unchanged} if fault == "state_unchanged"
             else {"program_problem": _half_positives})
    res, ok = run(tiny_context(workload, hooks=hooks))
    assert not ok, harness.check_lines(res)


def test_rank_altered_answer_fails():
    def alter(r, users, ids):
        ids = ids.copy()
        ids[0, 0] = (ids[0, -1] + 1) % 600 if ids[0, 0] != ids[0, -1] + 1 \
            else 0
        return ids
    res, ok = run(tiny_context(RANK, hooks={"served": alter}))
    assert not ok, harness.check_lines(res)


def test_rank_half_batch_fails():
    def half(r, users, ids):
        ids = ids.copy()
        ids[ids.shape[0] // 2:] = ids[0]  # the second half not ranked
        return ids
    res, ok = run(tiny_context(RANK, hooks={"served": half}))
    assert not ok, harness.check_lines(res)


def test_reference_gradient_is_the_loss_slope():
    """The reference's G is the derivative of its own loss, by a central
    difference on one table entry, float64."""
    ctx = tiny_context("kkbox-ffm-k64.train-skew")
    cfg = ctx.config
    p = gen.make_problem(cfg, ctx.traffic, 3)
    ref = Reference(p, {k: cfg[k] for k in ("k", "lam", "omega", "r",
                                            "cg_eps", "cg_max_iter",
                                            "self_side")}, "cpu")
    dims = table_dims(p.users.dims, p.items.dims, True)
    t = ref.cast(init_tables(dims, cfg["k"], 3, "cpu"))
    for b in ref.blocks:
        for first, key in ((True, "W"), (False, "H")):
            G, hv = ref.grad_hv(t, b, first)
            row = int(torch.argmax(G.abs().sum(dim=1)))
            h = 1e-4
            t[b.f12][key][row, 1] += h
            up = ref.objective(t)
            t[b.f12][key][row, 1] -= 2 * h
            down = ref.objective(t)
            t[b.f12][key][row, 1] += h
            assert (up - down) / (2 * h) == pytest.approx(
                float(G[row, 1]), rel=1e-5, abs=1e-8)
            V = torch.zeros_like(G)
            V[row, 1] = 1.0
            t[b.f12][key][row, 1] += h
            G2, _ = ref.grad_hv(t, b, first)
            t[b.f12][key][row, 1] -= h
            assert float(hv(V)[row, 1]) == pytest.approx(
                float((G2 - G)[row, 1]) / h, rel=1e-4)


def test_seeds_relabel_one_problem():
    """Two seeds give one problem in two orders: the same loss at the
    start tables and the same CG counts through an epoch, float64."""
    ctx = tiny_context("kkbox-ffm-k64.train-skew")
    cfg = ctx.config
    hyper = {k: cfg[k] for k in ("k", "lam", "omega", "r", "cg_eps",
                                 "cg_max_iter", "self_side")}
    seen = []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        p = gen.make_problem(cfg, ctx.traffic, seed)
        ref = Reference(p, hyper, "cpu")
        t = ref.cast(start_tables(p, True, cfg["k"], gen.STRUCTURE_SEED,
                                  "cpu"))
        loss0 = ref.objective(t)
        t, its = ref.epoch(t)
        seen.append((loss0, ref.objective(t), its, p.pos_v))
    (a0, a1, ia, va), (b0, b1, ib, vb) = seen
    assert not np.array_equal(va, vb)
    assert a0 == pytest.approx(b0, rel=1e-12)
    assert a1 == pytest.approx(b1, rel=1e-9)
    assert ia == ib
