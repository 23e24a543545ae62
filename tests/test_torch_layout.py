"""The port's numpy copy of make_blocked_layout equals the original."""

import numpy as np
import pytest
import torch

from one_class_ffm_tpu.ops.sparse_ops import (
    make_blocked_layout as make_blocked_layout_jax,
)
from one_class_ffm_torch.ops.layout import check_own_runs, make_blocked_layout

torch.set_num_threads(1)


def _stream(kind, rng):
    """(seg_ids, take_ids, num_rows, kwargs) of one stream shape."""
    num, n_other, nnz = 64, 40, 300
    if kind == "skewed":
        # three power rows hold most entries: the two-tier split engages
        num = 128
        seg = np.concatenate([rng.integers(0, num, size=120),
                              np.repeat([5, 17, 40], [600, 500, 400])])
        seg = np.sort(seg)
        return (seg.astype(np.int32),
                rng.integers(0, n_other, size=seg.size).astype(np.int32),
                num, dict(head_chunk=64))
    seg = rng.integers(0, num, size=nnz).astype(np.int32)
    take = rng.integers(0, n_other, size=nnz).astype(np.int32)
    kw = {}
    if kind == "sorted":
        seg = np.sort(seg)
    elif kind == "drop":
        seg = np.sort(seg)
        kw["drop"] = rng.random(nnz) < 0.2
    return seg, take, num, kw


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "drop", "skewed"])
@pytest.mark.parametrize("block_rows", [8, 16])
def test_layout_equals_original(kind, block_rows):
    rng = np.random.default_rng(11)
    seg, take, num, kw = _stream(kind, rng)
    ref = make_blocked_layout_jax(seg, take, num, block_rows, **kw)
    got = make_blocked_layout(seg, take, num, block_rows, **kw)
    assert ref is not None and got is not None
    assert sorted(got) == sorted(ref)
    if kind == "skewed":
        assert "hd_row" in got  # the head tier is compared too
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val),
                                      err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(val).dtype, key
    # the kernels' contiguous-run property holds on every block
    check_own_runs(got["own"], block_rows)


def test_layout_rejections_match():
    """Row counts not divisible by the block, and skew beyond the budget
    without a head tier, are rejected by both."""
    rng = np.random.default_rng(2)
    seg = np.sort(rng.integers(0, 30, size=100)).astype(np.int32)
    take = rng.integers(0, 9, size=100).astype(np.int32)
    assert make_blocked_layout(seg, take, 30, 8) is None
    assert make_blocked_layout_jax(seg, take, 30, 8) is None
    skew = np.sort(np.concatenate([np.arange(32), np.full(500, 3)]))
    tk = np.zeros(skew.size, np.int32)
    assert make_blocked_layout(skew, tk, 32, 8, head_chunk=0) is None
    assert make_blocked_layout_jax(skew, tk, 32, 8, head_chunk=0) is None


def test_check_own_runs_rejects_broken_runs():
    ok = np.array([[0, 0, 1, 3, 4, 4], [2, 2, 2, 4, 4, 4]], np.int32)
    check_own_runs(ok, 4)
    with pytest.raises(ValueError, match="contiguous"):
        check_own_runs(np.array([[0, 1, 0, 4]], np.int32), 4)
    with pytest.raises(ValueError, match="contiguous"):
        check_own_runs(np.array([[0, 4, 1, 4]], np.int32), 4)
    with pytest.raises(ValueError, match="outside"):
        check_own_runs(np.array([[0, 5]], np.int32), 4)
