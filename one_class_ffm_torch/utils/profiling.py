"""Per-phase wall timers.

``PhaseTimer`` is a copy of the one in ``one_class_ffm_tpu/utils/profiling.py``
(the port imports nothing of the JAX package); ``tests/test_torch_copies.py``
holds the two equal.  Device traces (the JAX package's ``trace_profile``) are
ROADMAP A12.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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
