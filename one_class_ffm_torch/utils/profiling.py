"""Per-phase wall timers and device traces.

``PhaseTimer`` is a copy of the one in ``one_class_ffm_tpu/utils/profiling.py``
(the port imports nothing of the JAX package); ``tests/test_torch_copies.py``
holds the two equal.  ``trace_profile`` is the counterpart of the JAX
package's context manager of the same name, on ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


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
    import torch
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
