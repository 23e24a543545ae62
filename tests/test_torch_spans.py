"""The solver's spans (``utils.profiling.span``): ranges ``ocffm/<name>`` in
an active ``torch.profiler`` trace, around the epoch's side sums and each
half-solve's gradient, CG and step, and around every host read of the CG
stop flag; nothing at all without a profiler.  On the CPU: the ranges'
counts and nesting in a toy epoch, the reads against ``cg_counts``, and an
epoch under the profiler against one without, bit for bit."""

import contextlib
import glob
import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from one_class_ffm_torch.solver.cg_graph import CgGraphs
from one_class_ffm_torch.utils import profiling
from test_torch_solver import build_port, ffm_problem, mf_problem

torch.set_num_threads(1)

PROBLEMS = {"ffm_self": lambda: ffm_problem("ffm_self", seed=3),
            "mf": lambda: mf_problem(seed=3)}
PHASES = ("grad", "cg", "step")


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(view[t.element_size()])


def _ranges(prof):
    """{name: sorted [(start, end)]} of the program's host ranges, the
    prefix taken off."""
    out = {}
    for e in prof.events():
        if e.name.startswith(profiling.SPAN_PREFIX) \
                and e.device_type == DeviceType.CPU:
            out.setdefault(e.name[len(profiling.SPAN_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(spans, lo, hi):
    return [(s, e) for s, e in spans if lo <= s and e <= hi]


def _profiled_epoch(solver, state):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = solver.epoch_stats(state)
    return out, _ranges(prof)


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse,
                        raising=False)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("solve", "f12=0"), profiling.span("cg.read")
    assert a is b and isinstance(a, contextlib.nullcontext)
    solver, state = build_port(*PROBLEMS["ffm_self"]())
    _, it = solver.epoch_stats(state)
    assert it.sum() > 0


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_epoch_ranges_nest_as_the_half_solves(case, fast, monkeypatch):
    """One side-sums range, then one range a half-solve, each holding
    exactly one gradient, one CG and one step range, in that order; the
    same from ``record_function`` where torch has no fast range."""
    if not fast:
        monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast",
                            raising=False)
    solver, state = build_port(*PROBLEMS[case]())
    (_, it), r = _profiled_epoch(solver, state)
    solves = r["solve"]
    assert len(r["sasb"]) == 1
    assert len(solves) == 2 * len(solver.blocks) == it.numel()
    assert r["sasb"][0][1] <= solves[0][0]
    for lo, hi in solves:
        inner = [_inside(r[p], lo, hi) for p in PHASES]
        assert [len(x) for x in inner] == [1, 1, 1]
        (g0, g1), (c0, c1), (s0, s1) = (x[0] for x in inner)
        assert g1 <= c0 and c1 <= s0
    for p in PHASES:
        assert len(r[p]) == len(solves)


@pytest.mark.parametrize("loop", ["host", "grouped"])
@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_flag_reads_are_the_counted_reads(case, loop):
    """Every host read of the stop flag is one ``cg.read`` range inside a
    ``cg`` range: one an iteration plus the first (the host loop), one a
    group of 3 (the grouped loop)."""
    solver, state = build_port(*PROBLEMS[case]())
    if loop == "host":
        solver.cg_host_loop = True
    else:
        solver.cg_group = 3
    before = solver.cg_counts["reads"]
    (_, it), r = _profiled_epoch(solver, state)
    reads = solver.cg_counts["reads"] - before
    want = (it + 1).sum() if loop == "host" else ((it + 2) // 3).sum()
    assert len(r["cg.read"]) == reads == int(want) > 0
    assert sum(len(_inside(r["cg.read"], lo, hi)) for lo, hi in r["cg"]) \
        == reads


def test_no_captures_off_the_card():
    """Captures are counted where CUDA graphs are captured, on the card:
    on the CPU the counts stay 0, and a bare ``CgGraphs`` starts at 0."""
    solver, state = build_port(*PROBLEMS["ffm_self"]())
    state, _ = solver.epoch_stats(state)
    _profiled_epoch(solver, state)
    assert solver.cg_counts["captures"] == 0
    assert solver.cg_counts["capture_s"] == 0.0
    assert CgGraphs(torch.device("cpu")).counts == dict(captures=0,
                                                        capture_s=0.0)


@pytest.mark.parametrize("case", sorted(PROBLEMS))
def test_profiled_epoch_is_the_plain_epoch_bit_for_bit(case):
    solver, state = build_port(*PROBLEMS[case]())
    c0 = dict(solver.cg_counts)
    plain, it_p = solver.epoch_stats(state)
    c1 = dict(solver.cg_counts)
    (traced, it_t), _ = _profiled_epoch(solver, state)
    c2 = dict(solver.cg_counts)
    assert torch.equal(it_t, it_p) and it_p.sum() > 0
    assert {k: c2[k] - c1[k] for k in c2} == {k: c1[k] - c0[k] for k in c1}
    for key in ("P", "Q", "params"):
        for f12, blk in plain[key].items():
            pairs = blk.items() if key == "params" else [(None, blk)]
            for name, t in pairs:
                u = traced[key][f12] if name is None \
                    else traced[key][f12][name]
                assert torch.equal(_bits(u), _bits(t)), (key, f12, name)
    for key in ("a", "b", "yt_u", "yt_v"):
        assert torch.equal(_bits(traced[key]), _bits(plain[key])), key


def test_profile_dir_trace_carries_the_spans(tmp_path):
    """The CLI's ``--profile-dir`` context (``trace_profile``) writes the
    solver's ranges into its Chrome trace."""
    solver, state = build_port(*PROBLEMS["ffm_self"]())
    with profiling.trace_profile(str(tmp_path), "cpu"):
        solver.epoch_stats(state)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"ocffm/" + n for n in ("sasb", "solve", "cg.read") + PHASES} \
        <= names
