"""The port's numpy copy of make_blocked_layout equals the original, and
the feature-major list of a field is its X^T."""

import numpy as np
import pytest
import torch

from one_class_ffm_tpu.ops.sparse_ops import (
    make_blocked_layout as make_blocked_layout_jax,
)
from one_class_ffm_torch.ops.layout import (
    check_own_runs,
    feature_major,
    make_blocked_layout,
)

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


@pytest.mark.parametrize("chunk", [2, 5, 128])
def test_feature_major_list_is_x_transposed(chunk):
    """The feature-major list holds every nonzero entry of X once (duplicate
    ids within a row stay separate), drops pad slots and pad rows, and cuts
    each feature's run into chunks of at most ``chunk`` entries in row
    order; the JAX package's transposed copies (xt_*) hold the same X."""
    rng = np.random.default_rng(3)
    rows, p, d = 40, 3, 9
    idx = rng.integers(0, d, size=(rows, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(rows, p))
    idx[:, 0] = 4  # one heavy feature
    idx[::3, 2] = idx[::3, 1]
    idx[rows - 4:], val[rows - 4:] = 0, 0.0  # pad rows
    idx[5, 1], val[5, 1] = 0, 0.0  # a pad slot
    fm = feature_major(idx, val, d, chunk=chunk)
    X = np.zeros((rows, d))
    np.add.at(X, (np.repeat(np.arange(rows), p), idx.ravel()), val.ravel())
    Xt = np.zeros((d, rows))
    for f in range(d):
        for c in range(fm.feat_ptr[f], fm.feat_ptr[f + 1]):
            s, e = fm.chunk_ptr[c], fm.chunk_ptr[c + 1]
            assert 0 < e - s <= chunk
            assert np.all(np.diff(fm.row[s:e]) >= 0)
            np.add.at(Xt[f], fm.row[s:e], fm.val[s:e])
    np.testing.assert_array_equal(Xt, X.T)
    assert fm.row.size == np.count_nonzero(val) and fm.n_rows == rows
    assert fm.chunk_ptr[-1] == fm.row.size
    heavy = np.count_nonzero((idx == 4) & (val != 0))
    assert fm.feat_ptr[5] - fm.feat_ptr[4] == -(-heavy // chunk)
    with pytest.raises(ValueError, match="outside"):
        feature_major(idx, val, 4)


# ---------------------------------------------------------------------------
# the static plans of the redesigned kernels: the X^T stage's (where each
# chunk's sum goes) and B2's (each row's run of slots)
# ---------------------------------------------------------------------------


def _conftest_fields(kind):
    """(idx, val, d) padded fields of tests/conftest.py's make_problem: an
    FFM side's small fields and an FM side's one mixed field."""
    from conftest import dense_to_padded, make_problem

    rng = np.random.default_rng(5)
    if kind == "conftest_ffm":
        prob, _ = make_problem(rng, m=40, n=30, Du=(40, 7), Dv=(30, 5),
                               max_nnz=3)
        Xs = prob.Xu + prob.Xv
    else:
        prob, _ = make_problem(rng, m=40, n=30, Du=(46,), Dv=(35,),
                               max_nnz=2)
        Xs = prob.Xu + prob.Xv
        Xs[0][:, :40] = np.eye(40)
    return [dense_to_padded(X) + (X.shape[1],) for X in Xs]


def _plan_fields(kind):
    """Fields whose lists cover every case of the plan: single-chunk,
    multi-chunk and featureless features."""
    if kind.startswith("conftest"):
        return [(idx, val, d, 2) for idx, val, d in _conftest_fields(kind)]
    rng = np.random.default_rng(9)
    rows, p, d = 300, 3, 50
    idx = rng.integers(0, d, size=(rows, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(rows, p))
    if kind == "heavy":  # one feature in every row, none for the last ids
        idx[:, 0] = 3
        idx[idx >= d - 5] = 0
        return [(idx, val, d, 128), (idx, val, d, 7)]
    # all single-chunk: every feature has at most `chunk` entries
    idx = np.arange(rows * p, dtype=np.int32).reshape(rows, p) % 400
    return [(idx, val, 400, 128)]


@pytest.mark.parametrize("kind", ["conftest_ffm", "conftest_fm", "heavy",
                                  "all_single"])
def test_xt_plan_follows_feat_ptr(kind):
    """``combine`` lists the features with other than one chunk; a single
    chunk writes its feature's output row; the other chunks take the
    partial rows 0, 1, ... in chunk order, one each, and ``slot_feat``
    names each partial row's feature."""
    from one_class_ffm_torch.ops.layout import xt_plan

    for idx, val, d, chunk in _plan_fields(kind):
        fm = feature_major(idx, val, d, chunk=chunk)
        nch = np.diff(fm.feat_ptr)
        np.testing.assert_array_equal(fm.combine, np.nonzero(nch != 1)[0])
        assert fm.combine.dtype == np.int32 and fm.chunk_dst.dtype == np.int32
        slot = 0
        for f in range(d):
            for c in range(fm.feat_ptr[f], fm.feat_ptr[f + 1]):
                if nch[f] == 1:
                    assert fm.chunk_dst[c] == -1 - f
                else:
                    assert fm.chunk_dst[c] == slot
                    assert fm.slot_feat[slot] == f
                    slot += 1
        # the wrapper sizes the partial array from the counts alone
        assert slot == fm.chunk_dst.size - (d - fm.combine.size)
        assert fm.slot_feat.shape == (slot,)
        assert fm.slot_feat.dtype == np.int32
        for got, ref in zip(xt_plan(fm.feat_ptr),
                            (fm.combine, fm.chunk_dst, fm.slot_feat)):
            np.testing.assert_array_equal(got, ref)
    if kind == "heavy":
        assert (nch > 1).any() and (nch == 0).any() and (nch == 1).any()
    if kind == "all_single":
        assert fm.combine.size == 0 and np.all(fm.chunk_dst < 0)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "drop", "skewed",
                                  "conftest"])
def test_row_runs_match_binary_search(kind):
    """B2's run pointer is what a binary search over each block's owners
    (``row_run``) finds, on the layouts of the tests' streams, a skewed one
    (its tail tier) and a tests/conftest.py problem's positives; the
    wrapper's on-device derivation agrees."""
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(12)
    block_rows = 8
    if kind == "conftest":
        from conftest import make_problem

        prob, _ = make_problem(rng, m=48, n=32, density=0.4)
        seg, take = (a.astype(np.int32) for a in np.nonzero(prob.pos))
        blk = make_blocked_layout(seg, take, 48, block_rows)
    else:
        seg, take, num, kw = _stream(kind, rng)
        blk = make_blocked_layout(seg, take, num, block_rows, **kw)
    own = blk["own"]
    check_own_runs(own, block_rows)
    runs = row_runs(own, block_rows)
    assert runs.shape == (own.shape[0], block_rows + 1)
    assert runs.dtype == np.int32
    for b in range(own.shape[0]):
        for r in range(block_rows + 1):
            lo, hi = 0, own.shape[1]  # lower_bound of r, as row_run does
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if own[b, mid] < r else (lo, mid)
            assert runs[b, r] == lo
        assert np.all(own[b, runs[b, block_rows]:] == block_rows)
    np.testing.assert_array_equal(
        kernels._runs(torch.from_numpy(own), block_rows).numpy(), runs)
