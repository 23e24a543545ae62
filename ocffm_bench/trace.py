"""Spans and the device trace of a run.

The harness marks each call into a layer of the program with a span
(``Spans.span``): a ``torch.profiler.record_function`` range named
``bench/<name>`` in a traced run, nothing in an untraced one.  A traced
window runs under ``torch.profiler`` (CPU and CUDA activities); ``digest``
reduces its events to what the metrics read:

- ``busy_s``, ``window_s``: the union of the device operations' intervals
  (kernels, copies, sets; the spans' own device-side ranges left out) and
  the span of all events;
- ``span_device_s``: per span name, the device time of the operations
  launched inside it;
- ``device_ops``: device seconds by operation name;
- ``idle_gaps``: the device's idle time between operations, by the
  innermost span the host was in at the middle of the gap;
- ``span_wall_s``, ``span_idle_s``: per span name, the host time inside
  its ranges (their union) and the device's idle time inside them.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench/"


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(e, "is_user_annotation", False) \
        and not e.name.startswith(PREFIX)


def busy_window(intervals: List[Tuple[float, float]]
                ) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy, merged) of (start, end) intervals: the length of their union
    and the union as sorted disjoint intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def label_gaps(merged: List[Tuple[float, float]], lo: float, hi: float,
               spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle time (the gaps of ``merged`` inside [lo, hi]) summed by the
    innermost span (latest start) that holds each gap's midpoint."""
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    spans = sorted(spans)
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label, mid = "outside spans", 0.5 * (g0 + g1)
        for s, e, name in spans:
            if s > mid:
                break
            if e >= mid:
                label = name
        out[label] += g1 - g0
    return dict(out)


def overlap(a: List[Tuple[float, float]],
            b: List[Tuple[float, float]]) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_idle(merged: List[Tuple[float, float]],
              spans: List[Tuple[float, float, str]]
              ) -> Dict[str, Tuple[float, float]]:
    """Per span name, (the union of its ranges' length, the idle time of
    the device inside them): ``merged`` are the device's busy intervals."""
    by: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for s, e, name in spans:
        by[name].append((s, e))
    out = {}
    for name, ivs in by.items():
        wall, union = busy_window(ivs)
        out[name] = (wall, wall - overlap(union, merged))
    return out


def digest(prof) -> Optional[dict]:
    """The trace's numbers in seconds, or None without device events."""
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    if not dev:
        return None
    busy, merged = busy_window([(e.time_range.start, e.time_range.end)
                                for e in dev])
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    host_spans = [(e.time_range.start, e.time_range.end,
                   e.name[len(PREFIX):]) for e in events
                  if e.name.startswith(PREFIX) and not _is_device(e)
                  and e.device_type != torch.autograd.DeviceType.CUDA]
    span_dev: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.name.startswith(PREFIX) \
                and e.device_type != torch.autograd.DeviceType.CUDA:
            span_dev[e.name[len(PREFIX):]] += e.device_time_total * 1e-6
    ops: Dict[str, float] = defaultdict(float)
    for e in dev:
        ops[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    gaps = label_gaps(merged, lo, hi, host_spans)
    inside = span_idle(merged, host_spans)
    return dict(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                span_device_s=dict(span_dev), device_ops=dict(ops),
                idle_gaps={k: v * 1e-6 for k, v in gaps.items()},
                span_wall_s={k: v[0] * 1e-6 for k, v in inside.items()},
                span_idle_s={k: v[1] * 1e-6 for k, v in inside.items()})


def breakdown(d: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations with the
    most time and the ten span labels with the most idle time."""
    def top(m):
        return [[k, v] for k, v in sorted(m.items(), key=lambda kv: -kv[1])
                [:10]]
    return dict(device_ops=top(d["device_ops"]),
                idle_gaps=top(d["idle_gaps"]))
