"""Per-phase wall timers and device traces.

``PhaseTimer`` is a copy of the one in ``one_class_ffm_tpu/utils/profiling.py``
(the port imports nothing of the JAX package); ``tests/test_torch_copies.py``
holds the two equal.  ``trace_profile`` is the counterpart of the JAX
package's context manager of the same name, on ``torch.profiler``.
``span`` marks a phase of the program (``ocffm/<name>``) in whatever
``torch.profiler`` trace is being taken, and costs one C query otherwise.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

SPAN_PREFIX = "ocffm/"
_NO_SPAN = contextlib.nullcontext()


class PhaseTimer:
    """Accumulates wall time per named phase.

    with timer.phase("epoch"):
        ...
    timer.summary() -> {"epoch": {"seconds": ..., "calls": ...}, ...}
    """

    def __init__(self):
        self._tot: Dict[str, float] = defaultdict(float)
        self._cnt: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._tot[name] += time.perf_counter() - t0
            self._cnt[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._tot[name] += seconds
        self._cnt[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"seconds": self._tot[k], "calls": self._cnt[k]}
            for k in sorted(self._tot)
        }

    def report(self, echo=print) -> None:
        for name, s in self.summary().items():
            avg = s["seconds"] / max(s["calls"], 1)
            echo(f"[timing] {name:>16}: {s['seconds']:8.3f}s total, "
                 f"{int(s['calls'])} calls, {avg:8.4f}s avg")


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str], device="cpu") -> Iterator[None]:
    """torch.profiler trace around a block (no-op when log_dir is falsy),
    written under ``log_dir`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``, TensorBoard's and Perfetto's
    format): host operators always, the card's kernels too when ``device``
    is a CUDA device."""
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def span(name: str, args: Optional[str] = None):
    """A range ``ocffm/<name>`` (with ``args``, a string, beside it) in the
    active ``torch.profiler`` trace, on the clock of the kernels in the
    same trace; the kernels launched inside it are charged to it.  The
    range is torch's fast ``RecordFunction`` (the one its compiler marks
    kernels with: one record, no dispatched enter and exit ops, about an
    eighth of ``record_function``'s cost under the profiler, and the
    kernels of a CUDA graph replayed inside it are linked to it, which
    ``record_function`` leaves linked to nothing), else
    ``record_function``.  Without an active profiler it is one shared
    null context: no range is made."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.profiler.record_function(SPAN_PREFIX + name, args)
    return fast(SPAN_PREFIX + name, (), {} if args is None else
                {"args": args})
