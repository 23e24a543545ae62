"""The program's own spans in a traced training job, by phase of the
half-solve, and a run of a training cell that reads them.

The port marks its phases in any active ``torch.profiler`` trace
(``one_class_ffm_torch.utils.profiling.span``): ``ocffm/sasb`` (an
epoch's side sums), ``ocffm/solve`` (a half-solve) and inside it
``ocffm/grad``, ``ocffm/cg`` and ``ocffm/step``, ``ocffm/cg.read`` (each
host wait on the CG stop flag) and ``ocffm/cg.capture`` (a CUDA graph
capture).  Here:

- ``program_digest``: per program span name, the host time inside its
  ranges (``program_span_wall_s``), the device's idle time inside them
  (``program_span_idle_s``) and the device time of the operations
  launched inside them (``program_span_device_s``); the idle gaps labelled
  by the innermost span of the harness's and the program's; and the check
  of the profiler's own links (``linked_share``: a replayed graph's
  kernels are linked only through a range around the replay);
- ``phase_work``: ``work.epoch_work``'s passes filed by phase;
- ``phase_numbers``: per phase of the half-solve its idle share of the
  traced job and its roofline share (required work over device time).

These are not metrics of ``BENCHMARK.json``: a reader is handed only the
driver's ``run``, which holds neither the program's spans nor the phase
work nor the set-up's capture seconds.  This file measures them beside a
cell's own run:

    python3 ocffm_bench/phases.py --workload <train cell> --seed <n> \\
        --seconds <s> [--spans 0]

runs the cell's driver with its first window job traced, as ``run.py
--trace 1`` does, and prints one JSON line: the cell's per-layer readings,
the traced job's wall time, the phase numbers and the spans' digest.
``--spans 0`` makes every program span the null context, so two runs give
the spans' cost under the profiler.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ocffm_bench import harness, trace, work  # noqa: E402

PROGRAM = "ocffm/"
PHASES = ("sasb", "grad", "cg", "step")
SOLVE_PHASES = ("grad", "cg", "step")
# the least share of the harness's epoch spans' device time that the phases
# must hold before a phase's roofline share is given
COVERAGE = 0.95
# the phase of each pass of ``work.epoch_work``, in the order it adds them:
# per half-solve the gradient, the CG start, the Hv, the recurrence and the
# step (the side sums first, in a model with self blocks)
SOLVE_PASSES = ("grad", "cg", "cg", "cg", "step")
# host events of the CUDA runtime and driver calls (``cudaLaunchKernel``,
# ``cudaGraphLaunch``, ``cuLaunchKernel``, ...): a device operation carries
# its launch's correlation id
RUNTIME = "cu"


def _holders(spans, times: Sequence[float]) -> List[List[str]]:
    """For each time, the names of the (start, end, name) spans that hold
    it; the spans nest (one thread's ranges), so one sweep with a stack,
    an outer span before an inner one of the same start, a span that ends
    where the next begins taken off as it begins."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out: List[List[str]] = [[] for _ in times]
    stack: List[tuple] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = [name for _, _, name in stack]
    return out


def program_digest(prof) -> Optional[dict]:
    """The program spans' numbers in seconds, or None without device
    events.  Device operations are ``trace``'s; each is charged to every
    span, the harness's and the program's, that holds the host time of its
    launch: the runtime or driver call with its correlation id, for a
    replayed graph's kernels the graph's launch.  ``linked_share`` is the
    device time that the profiler's own links give the harness's
    ``restore`` and ``epoch`` spans (``device_time_total``, which
    ``trace.digest``'s ``span_device_s`` follows) over what they are
    charged here: under 1 the profiler left kernels unlinked."""
    events = list(prof.events())
    dev = [e for e in events if trace._is_device(e)]
    if not dev:
        return None
    _, merged = trace.busy_window([(e.time_range.start, e.time_range.end)
                                   for e in dev])
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name.startswith((PROGRAM, trace.PREFIX))]
    prog = sorted((s, e, n[len(PROGRAM):]) for s, e, n in spans
                  if n.startswith(PROGRAM))
    runtime = {e.id: e.time_range.start for e in host
               if e.name.startswith(RUNTIME)}
    launched = [e for e in dev if e.id in runtime]
    charged: Dict[str, float] = defaultdict(float)
    for e, names in zip(launched, _holders(spans, [runtime[e.id]
                                                   for e in launched])):
        for name in names:
            charged[name] += (e.time_range.end - e.time_range.start) * 1e-6
    top = [trace.PREFIX + "restore", trace.PREFIX + "epoch"]
    linked = sum(e.device_time_total for e in host if e.name in top) * 1e-6
    inside = trace.span_idle(merged, prog)
    gaps = trace.label_gaps(merged, lo, hi, sorted(
        (s, e, n if n.startswith(PROGRAM) else n[len(trace.PREFIX):])
        for s, e, n in spans))
    return dict(
        program_span_wall_s={k: v[0] * 1e-6 for k, v in inside.items()},
        program_span_idle_s={k: v[1] * 1e-6 for k, v in inside.items()},
        program_span_device_s={n[len(PROGRAM):]: v for n, v in
                               charged.items() if n.startswith(PROGRAM)},
        program_span_count={n: sum(1 for s in prog if s[2] == n)
                            for n in sorted({s[2] for s in prog})},
        epoch_device_s=charged[top[1]],
        idle_gaps={k: v * 1e-6 for k, v in gaps.items()},
        device_total_s=sum(e.time_range.end - e.time_range.start
                           for e in dev) * 1e-6,
        unlaunched_s=sum(e.time_range.end - e.time_range.start
                         for e in dev if e.id not in runtime) * 1e-6,
        linked_share=linked / sum(charged[n] for n in top)
        if any(charged[n] for n in top) else 0.0,
        program_ops=sum(1 for e in dev if e.name.startswith(PROGRAM)))


class _Passes(work.Counter):
    """A ``work.Counter`` that keeps each pass it is given."""

    def __init__(self, peaks):
        super().__init__(peaks)
        self.passes: List[tuple] = []

    def add(self, flops: float, nbytes: float, times: float = 1.0) -> None:
        self.passes.append((flops, nbytes, times))
        super().add(flops, nbytes, times)


def phase_work(s: work.Shape, cg_iters: Sequence[Sequence[int]],
               peaks: Dict[str, float]) -> Dict[str, work.Counter]:
    """The required work of the epochs with these per-solve CG counts, by
    phase: the self gradients' sums over the other side (``sasb``), each
    half-solve's gradient (``grad``), its CG start and every Hv with its
    recurrence (``cg``), and its step (``step``).  The passes are
    ``work.epoch_work``'s, so the phases add up to its total."""
    out = {p: work.Counter(peaks) for p in PHASES}
    for its in cg_iters:
        rec = _Passes(peaks)
        work.epoch_work(s, its, rec)
        order = ["sasb"] * s.self_side + list(SOLVE_PASSES) * len(its)
        if len(order) != len(rec.passes):
            raise RuntimeError(f"work.epoch_work added {len(rec.passes)} "
                               f"passes, not the {len(order)} filed here")
        for phase, args in zip(order, rec.passes):
            out[phase].add(*args)
    return out


def phase_numbers(digest: dict, program: dict,
                  bound_s: Dict[str, float]) -> Dict[str, Optional[float]]:
    """Per phase of the half-solve, in %: ``<phase>_idle_share.train`` (the
    device's idle time inside the phase's spans over the traced job's
    window) and ``<phase>_roofline.train`` (the phase's required work at
    the card's peaks over the device time launched inside its spans);
    None where the spans are missing, where a phase has no device time,
    and for every roofline where the four phases hold under ``COVERAGE`` of
    the harness's epoch spans' device time."""
    out: Dict[str, Optional[float]] = {}
    wall = program["program_span_wall_s"]
    idle = program["program_span_idle_s"]
    dev = program["program_span_device_s"]
    epoch = program["epoch_device_s"]
    held = sum(dev.get(p, 0.0) for p in PHASES)
    covered = epoch > 0 and held >= COVERAGE * epoch
    for p in SOLVE_PHASES:
        out[f"{p}_idle_share.train"] = (
            100.0 * idle[p] / digest["window_s"]
            if p in wall and digest["window_s"] > 0 else None)
        out[f"{p}_roofline.train"] = (
            100.0 * bound_s[p] / dev[p]
            if covered and dev.get(p, 0.0) > 0 else None)
    return out


def idle_split(digest: dict, program: dict) -> Dict[str, float]:
    """The traced job's idle time in % of its window, split exactly: inside
    each phase's spans, what of the harness's ``epoch`` spans no phase
    holds (``epoch_rest``), inside ``restore``, and outside both
    (``outside``); they add up to ``idle_share.train``."""
    w = digest["window_s"]
    idle = program["program_span_idle_s"]
    epoch = digest["span_idle_s"].get("epoch", 0.0)
    restore = digest["span_idle_s"].get("restore", 0.0)
    out = {p: 100.0 * idle.get(p, 0.0) / w for p in PHASES}
    out["epoch_rest"] = 100.0 * (epoch - sum(idle.get(p, 0.0)
                                             for p in PHASES)) / w
    out["restore"] = 100.0 * restore / w
    out["outside"] = 100.0 * (w - digest["busy_s"] - epoch - restore) / w
    return out


@contextlib.contextmanager
def null_spans():
    """Inside the block, ``profiling.span`` is the null context in every
    loaded module of the program that took it (the cost of the spans under
    a profiler is a run's with them less one's inside this block)."""
    from one_class_ffm_torch.solver import torch_solver  # noqa: F401
    from one_class_ffm_torch.utils import profiling

    real = profiling.span
    took = [mod for mod in list(sys.modules.values())
            if getattr(mod, "span", None) is real]
    for mod in took:
        mod.span = lambda name, args=None: contextlib.nullcontext()
    try:
        yield len(took)
    finally:
        for mod in took:
            mod.span = real


def measure(bench: dict, ctx, spans: bool = True) -> dict:
    """Run a training cell's driver (``ctx.traced``: its first window job
    traced) and read the program's spans beside its own digest: the cell's
    per-layer readings, the set-up's graph captures and their host
    seconds, the captures made inside the traced job (0 unless a graph was
    rebuilt), and with device events the phase numbers."""
    if ctx.traffic["driver"] != "train":
        raise ValueError(f"{ctx.workload} is no training cell")
    solvers: list = []
    seen: dict = {}

    def problem(p):
        seen["positives"] = int(p.pos_u.shape[0])
        return p

    def profiler():
        seen["before"] = dict(solvers[0].cg_counts)
        return make_profiler()

    def digest(prof):
        seen["after"] = dict(solvers[0].cg_counts)
        seen["program"] = program_digest(prof)
        return make_digest(prof)

    ctx.hooks.update(solver=solvers.append, program_problem=problem)
    make_profiler, make_digest = trace.profiler, trace.digest
    trace.profiler, trace.digest = profiler, digest
    try:
        with (contextlib.nullcontext(0) if spans else null_spans()) as n:
            res = harness.run_driver(ctx)
    finally:
        trace.profiler, trace.digest = make_profiler, make_digest
    run, program = res.run, seen.get("program")
    before, after = seen.get("before", {}), seen.get("after", {})
    line = dict(workload=ctx.workload, seed=ctx.seed, spans=spans,
                nulled_modules=n,
                correct=bool(res.checks) and all(c.ok for c in res.checks),
                end_to_end=res.end_to_end,
                traced_wall_s=run.get("traced_wall_s"),
                cg_capture_s=before.get("capture_s"),
                captures=before.get("captures"),
                captures_in_window=after.get("captures", 0)
                - before.get("captures", 0))
    line["metrics"] = {
        m["name"]: harness.load_reader(m["name"])(run)
        for m in harness.cell_metrics(bench, ctx.workload, True)}
    if program is not None and run.get("digest") is not None:
        epochs = int(ctx.traffic["epochs_per_job"])
        bound = {p: cnt.seconds for p, cnt in phase_work(
            work.shape_of(ctx.config, seen["positives"]),
            run["cg_iters"][:epochs],
            work.load_peaks(torch.cuda.get_device_name(ctx.device))).items()}
        line.update(phase_bound_s=bound,
                    phases=phase_numbers(run["digest"], program, bound),
                    idle_split=idle_split(run["digest"], program),
                    program=program)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm_bench/phases.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ocffm_bench/phases.py: no CUDA device: nothing measured",
              file=sys.stderr)
        return 2
    bench, _, ctx = harness.make_context(
        args.workload, args.seed, args.seconds, True, "cuda:0", T_START)
    line = measure(bench, ctx, bool(args.spans))
    line["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
