"""The trace's reductions on hand-made intervals."""

import pytest

from ocffm_bench import trace


def test_busy_is_the_union():
    busy, merged = trace.busy_window([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert busy == pytest.approx(4.0)
    assert merged == [(0, 3), (5, 6)]


def test_gaps_take_the_innermost_span():
    merged = [(1.0, 2.0), (4.0, 5.0)]
    spans = [(0.0, 10.0, "request"), (2.0, 3.5, "rank_topk")]
    gaps = trace.label_gaps(merged, 0.0, 6.0, spans)
    assert gaps == {"request": pytest.approx(1.0 + 1.0),
                    "rank_topk": pytest.approx(2.0)}


def test_gaps_outside_spans():
    gaps = trace.label_gaps([(1.0, 2.0)], 0.0, 2.0, [])
    assert gaps == {"outside spans": pytest.approx(1.0)}


def test_idle_inside_spans():
    busy = [(1.0, 2.0), (4.0, 5.0)]
    spans = [(0.0, 3.0, "request"), (3.0, 3.5, "wait_due"),
             (3.5, 6.0, "request")]
    out = trace.span_idle(busy, spans)
    assert out["request"] == (pytest.approx(5.5), pytest.approx(3.5))
    assert out["wait_due"] == (pytest.approx(0.5), pytest.approx(0.5))
    assert trace.overlap([(0, 1), (2, 3)], [(0.5, 2.5)]) == pytest.approx(1.0)


def test_breakdown_keeps_ten():
    d = dict(device_ops={f"k{i}": float(i) for i in range(15)},
             idle_gaps={"a": 1.0, "b": 2.0})
    b = trace.breakdown(d)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k14", 14.0]
    assert b["idle_gaps"] == [["b", 2.0], ["a", 1.0]]
