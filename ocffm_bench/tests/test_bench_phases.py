"""The program's spans read beside the harness's (``phases.py``): on a
hand-made trace, the program's ranges change nothing that ``trace.digest``
and the accepted readers read, are never device operations, take the idle
gaps they hold, and are charged the device time launched inside them; the
phase work adds up to ``work.epoch_work``'s; and a tiny training cell runs
through ``measure`` on the CPU."""

import os
import types

import pytest
import torch

from ocffm_bench import harness, phases, trace, work
from ocffm_bench.tests.common import load, tiny_context

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ev(name, start, end, device=CPU, dev_total=0.0, annotation=False,
       cid=0, linked=0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, device_time_total=dev_total,
        is_user_annotation=annotation, id=cid, linked_correlation_id=linked)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


# host spans (us): the harness's restore and epoch, a request with its
# sort; inside the epoch the program's side sums and one half-solve
HARNESS = [ev("bench/restore", 0, 10, dev_total=5.0),
           ev("bench/epoch", 10, 100, dev_total=45.0),
           ev("bench/request", 110, 140, dev_total=12.0),
           ev("bench/rank_topk", 120, 130, dev_total=8.0)]
PROGRAM = [ev("ocffm/sasb", 11, 15, dev_total=2.0),
           ev("ocffm/solve", 16, 95, dev_total=43.0),
           ev("ocffm/grad", 17, 40, dev_total=15.0),
           ev("ocffm/cg", 41, 80, dev_total=22.0),
           ev("ocffm/cg.read", 70, 80, dev_total=0.0),
           ev("ocffm/step", 81, 94, dev_total=6.0)]
# (name, launch time, device start, device end, correlation id); the
# graph's kernels carry the id of its one launch
KERNELS = [("restore_k", 2, 3, 8, 1), ("sasb_k", 12, 12.5, 14.5, 2),
           ("grad_k", 18, 20, 35, 3), ("graph_k1", 45, 46, 60, 4),
           ("graph_k2", 45, 60, 68, 4), ("step_k", 82, 84, 90, 5),
           ("sort_k", 121, 122, 130, 6), ("score_k", 111, 112, 116, 7)]


def runtime_and_kernels():
    out = []
    for name, t, s, e, cid in KERNELS:
        if not any(x.id == cid for x in out):
            out.append(ev("cudaGraphLaunch" if name.startswith("graph")
                          else "cudaLaunchKernel", t, t + 0.5, cid=cid,
                          linked=100 + cid))
        out.append(ev(name, s, e, device=CUDA, cid=cid, linked=100 + cid))
    return out


def device_annotations(host):
    """The device-side ranges a profiler adds for each host range: the
    span of the operations launched inside it."""
    out = []
    for h in host:
        ks = [(s, e) for _, t, s, e, _ in KERNELS
              if h.time_range.start <= t <= h.time_range.end]
        if ks:
            out.append(ev(h.name, min(s for s, _ in ks),
                          max(e for _, e in ks), device=CUDA,
                          annotation=True))
    return out


def trace_of(with_program: bool) -> Prof:
    host = HARNESS + (PROGRAM if with_program else [])
    return Prof(host + runtime_and_kernels() + device_annotations(host))


def test_program_ranges_are_never_device_operations():
    prof = trace_of(True)
    assert not any(trace._is_device(e) for e in prof.events()
                   if e.name.startswith(phases.PROGRAM))
    assert phases.program_digest(prof)["program_ops"] == 0


def test_program_ranges_leave_the_harness_digest_and_readers_as_they_were():
    base, more = trace.digest(trace_of(False)), trace.digest(trace_of(True))
    assert more == base
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for m in bench["per_layer"]:
        read = harness.load_reader(m["name"])
        runs = [dict(digest=d, bound_s=1e-5, traced_wall_s=2e-4,
                     service_s=[3e-5, 4e-5], cg_iters=[[1, 2]], build_s=1.0)
                for d in (base, more)]
        assert read(runs[1]) == read(runs[0]), m["name"]
        assert read(runs[0]) is not None, m["name"]


def test_gaps_take_the_innermost_span_of_either_prefix():
    d = phases.program_digest(trace_of(True))
    gaps = d["idle_gaps"]
    # gap 14.5-20 (mid 17.25) in grad; 35-46 (mid 40.5) in the solve
    # between grad and cg; 68-84 (mid 76) in the flag read; 90-112 (mid
    # 101) outside every span; 8-12.5 (mid 10.25) in the epoch; 0-3 in
    # the restore; 116-122 and 130-140 in the request, not its sort
    assert gaps["ocffm/grad"] == pytest.approx(5.5e-6)
    assert gaps["ocffm/solve"] == pytest.approx(11e-6)
    assert gaps["ocffm/cg.read"] == pytest.approx(16e-6)
    assert gaps["outside spans"] == pytest.approx(22e-6)
    assert gaps["epoch"] == pytest.approx(4.5e-6)
    assert gaps["restore"] == pytest.approx(3e-6)
    assert gaps["request"] == pytest.approx(16e-6)
    assert sum(gaps.values()) == pytest.approx(
        trace.digest(trace_of(True))["window_s"]
        - trace.digest(trace_of(True))["busy_s"])


def test_spans_are_charged_what_was_launched_inside_them():
    d = phases.program_digest(trace_of(True))
    want = {"sasb": 2e-6, "solve": 43e-6, "grad": 15e-6, "cg": 22e-6,
            "step": 6e-6}
    for name, s in want.items():
        assert d["program_span_device_s"][name] == pytest.approx(s), name
    assert "cg.read" not in d["program_span_device_s"]
    assert d["epoch_device_s"] == pytest.approx(45e-6)
    assert d["unlaunched_s"] == 0.0
    assert d["program_span_count"] == {"cg": 1, "cg.read": 1, "grad": 1,
                                       "sasb": 1, "solve": 1, "step": 1}
    # cg: 41-80 with the device busy 46-68; cg.read 70-80, all idle
    assert d["program_span_wall_s"]["cg"] == pytest.approx(39e-6)
    assert d["program_span_idle_s"]["cg"] == pytest.approx(17e-6)
    assert d["program_span_idle_s"]["cg.read"] == pytest.approx(10e-6)
    assert d["linked_share"] == pytest.approx(1.0)
    assert d["device_total_s"] == pytest.approx(62e-6)


def test_charges_do_not_follow_the_profilers_links():
    """Where the profiler links a graph's kernels to nothing (its epoch
    span's device_time_total without them), each kernel is still charged
    to the spans around its graph's launch, and ``linked_share`` says what
    the links missed."""
    prof = trace_of(True)
    for e in prof._events:
        if e.name == "bench/epoch" and e.device_type == CPU:
            prof._events[prof._events.index(e)] = ev(
                e.name, 10, 100, dev_total=45.0 - 22.0)
    d = phases.program_digest(prof)
    assert d["program_span_device_s"]["cg"] == pytest.approx(22e-6)
    assert d["epoch_device_s"] == pytest.approx(45e-6)
    assert d["linked_share"] == pytest.approx(28.0 / 50.0)


def test_holders_of_nested_spans_sharing_a_start():
    spans = [(0, 10, "inner"), (0, 20, "outer"), (12, 15, "late"),
             (15, 18, "next")]
    assert phases._holders(spans, [5, 11, 13, 25, 10, 16]) == [
        ["outer", "inner"], ["outer"], ["outer", "late"], [],
        ["outer", "inner"], ["outer", "next"]]


def _digests():
    prof = trace_of(True)
    return trace.digest(prof), phases.program_digest(prof)


def test_phase_numbers_by_hand():
    digest, program = _digests()
    bound = {"sasb": 1e-6, "grad": 3e-6, "cg": 11e-6, "step": 3e-6}
    out = phases.phase_numbers(digest, program, bound)
    w = digest["window_s"]
    assert out["grad_idle_share.train"] == pytest.approx(
        100 * program["program_span_idle_s"]["grad"] / w)
    assert out["cg_idle_share.train"] == pytest.approx(100 * 17e-6 / w)
    assert out["grad_roofline.train"] == pytest.approx(20.0)
    assert out["cg_roofline.train"] == pytest.approx(50.0)
    assert out["step_roofline.train"] == pytest.approx(50.0)


def test_phase_numbers_refuse_what_the_trace_cannot_hold():
    digest, program = _digests()
    bound = {"sasb": 1e-6, "grad": 3e-6, "cg": 11e-6, "step": 3e-6}
    # the phases hold 45 of the epoch's 45: take 5 us from cg, under 95%
    short = dict(program, program_span_device_s=dict(
        program["program_span_device_s"], cg=17e-6))
    out = phases.phase_numbers(digest, short, bound)
    assert all(out[f"{p}_roofline.train"] is None
               for p in phases.SOLVE_PHASES)
    assert out["cg_idle_share.train"] is not None
    # a phase with no device time, and no step spans at all
    none = dict(program, program_span_device_s=dict(
        program["program_span_device_s"], step=0.0, grad=21e-6),
        program_span_wall_s={k: v for k, v in
                             program["program_span_wall_s"].items()
                             if k != "step"})
    out = phases.phase_numbers(digest, none, bound)
    assert out["step_roofline.train"] is None
    assert out["step_idle_share.train"] is None
    assert out["grad_roofline.train"] == pytest.approx(100 * 3 / 21)


def test_idle_split_adds_up_to_the_idle_share():
    digest, program = _digests()
    split = phases.idle_split(digest, program)
    w = digest["window_s"]
    assert sum(split.values()) == pytest.approx(
        100 * (1 - digest["busy_s"] / w))
    # the epoch's 45 idle us less the phases' 2 + 8 + 17 + 7
    assert split["epoch_rest"] == pytest.approx(100 * 11e-6 / w)
    assert split["restore"] == pytest.approx(100 * 5e-6 / w)
    assert split["cg"] == pytest.approx(100 * 17e-6 / w)


@pytest.mark.parametrize("config", ["kkbox-ffm-k64", "kkbox-mf-k32"])
def test_phase_work_adds_up_to_epoch_work(config):
    cfg = load(f"configs/{config}.json")
    s = work.shape_of(cfg, 2972163)
    n = len(work.half_solves(s))
    iters = [[(3 * i + e) % 21 for i in range(n)] for e in range(3)]
    peaks = work.load_peaks("NVIDIA H100 80GB HBM3")
    total = work.Counter(peaks)
    for its in iters:
        work.epoch_work(s, its, total)
    parts = phases.phase_work(s, iters, peaks)
    assert sum(c.flops for c in parts.values()) == total.flops
    assert sum(c.bytes for c in parts.values()) == total.bytes
    assert sum(c.seconds for c in parts.values()) == pytest.approx(
        total.seconds, rel=1e-12)
    assert (parts["sasb"].flops > 0) == s.self_side
    assert all(parts[p].seconds > 0 for p in phases.SOLVE_PHASES)


def test_measure_runs_a_tiny_cell_on_the_cpu():
    """No device events on the CPU, so no phase numbers; the program's
    counts and the cell's readers are read, no capture is made, and with
    the spans nulled the program's modules are restored after."""
    from one_class_ffm_torch.solver import torch_solver
    from one_class_ffm_torch.utils import profiling

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for spans in (True, False):
        ctx = tiny_context("kkbox-mf-k32.train-uniform", traced=True)
        line = phases.measure(bench, ctx, spans)
        assert line["correct"] and line["captures"] == 0
        assert line["captures_in_window"] == 0
        assert "phases" not in line
        assert set(line["metrics"]) == {
            m["name"] for m in harness.cell_metrics(
                bench, "kkbox-mf-k32.train-uniform", True)}
        assert (line["nulled_modules"] > 0) == (not spans)
    assert torch_solver.span is profiling.span
    with pytest.raises(ValueError):
        phases.measure(bench, tiny_context("kkbox-ffm-k64.rank-b1024"))
