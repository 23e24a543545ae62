"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc (sm_90a) and skip
elsewhere.  On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as ops
from one_class_ffm_torch.ops.layout import (
    FeatureMajor,
    feature_major,
    make_blocked_layout,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

BOUND = {torch.float32: 1e-5, torch.bfloat16: 5e-3}  # max-rel


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _stream(seed, k, sorted_seg):
    rng = np.random.default_rng(seed)
    num, n_other, nnz, BM = 512, 300, 4000, 64
    seg = rng.integers(0, num, size=nnz).astype(np.int32)
    if sorted_seg:
        seg = np.sort(seg)
    take = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(seg, take, num, BM, max_pad_ratio=50.0)
    B = rng.normal(size=(n_other, k))
    return rng, num, BM, blk, B[blk["take"]]


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("sorted_seg", [True, False])
def test_kernels_match_plain(device, dtype, k, sorted_seg):
    rng, num, BM, blk, rows = _stream(1, k, sorted_seg)

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own = torch.as_tensor(blk["own"], device=device)
    x_rows = T(rows)
    phi, dP = T(rng.normal(size=(num, k))), T(rng.normal(size=(num, k)))
    w = T(rng.random(blk["own"].shape) * (blk["own"] < BM))
    c = T(rng.normal(size=blk["own"].shape))
    dense = T(rng.normal(size=(k, k)))
    cases = {
        "pos_hv_blocked": (phi, x_rows, own, w, dense, num, BM, 0.9),
        "pos_scatter_blocked": (c, x_rows, own, num, BM),
        "pos_gap_blocked": (dP, x_rows, own, BM),
    }
    kernels.reset_launch_counts()
    for name, args in cases.items():
        got = getattr(ops, name)(*args)  # the dispatcher launches on CUDA
        again = getattr(kernels, name)(*args)
        ref = getattr(ops, name + "_plain")(*args)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, again), f"{name}: launches differ"
        assert _max_rel(got, ref) <= BOUND[dtype], name
        # the plain versions add in the kernels' order: equal bits
        assert torch.equal(got, ref), name
    assert kernels.launch_counts() == {
        name: 2 if name in cases else 0 for name in kernels.KERNELS}


def _field(rng, num, d, p=3, n_pad_rows=5):
    """A feature field (num, p): duplicate ids within rows, pad slots (idx
    0, val 0), pad rows at the end, and feature 3 in every real row, so
    that its run spans several chunks."""
    idx = rng.integers(0, d, size=(num, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(num, p))
    idx[:, 0] = 3
    idx[::7, 2] = idx[::7, 1]  # duplicate ids within a row
    pad = rng.random((num, p)) < 0.2
    pad[:, 0] = False
    idx[pad], val[pad] = 0, 0.0
    idx[num - n_pad_rows:], val[num - n_pad_rows:] = 0, 0.0
    return idx, val


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("sorted_seg", [True, False])
def test_table_kernels_match_plain(device, dtype, k, sorted_seg):
    rng, num, BM, blk, rows = _stream(4, k, sorted_seg)
    d = 37
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)
    assert int(np.diff(fm.feat_ptr)[3]) > 1  # the heavy feature is split

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = FeatureMajor(row=I(fm.row), val=T(fm.val), chunk_ptr=I(fm.chunk_ptr),
                      feat_ptr=I(fm.feat_ptr), n_rows=fm.n_rows)
    x_idx, x_val = I(idx), T(val)
    own = I(blk["own"])
    x_rows = T(rows)
    V = T(rng.normal(size=(d, k)))
    Q1 = T(rng.normal(size=(num, k)))
    w = T(rng.random(blk["own"].shape) * (blk["own"] < BM))
    c = T(rng.normal(size=blk["own"].shape))
    dense_mat, dense = T(rng.normal(size=(k, k))), T(rng.normal(size=(num, k)))
    dd, zdense = T(rng.random(num) * 5), T(rng.normal(size=num))
    cases = {
        "pos_hv_tbl": (V, x_idx, x_val, xt, x_rows, own, w, dense_mat, BM,
                       0.9),
        "grad_cross_tbl": (xt, x_rows, own, c, dense, BM),
        "hv_self_tbl": (V, x_idx, x_val, xt, Q1, dd),
        "grad_self_tbl": (xt, Q1, zdense, own, c, BM),
    }
    kernels.reset_launch_counts()
    for name, args in cases.items():
        got = getattr(ops, name)(*args)  # the dispatcher launches on CUDA
        again = getattr(kernels, name)(*args)
        ref = getattr(ops, name + "_plain")(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (d, k)
        assert torch.equal(got, again), f"{name}: launches differ"
        assert _max_rel(got, ref) <= BOUND[dtype], name
        assert torch.equal(got, ref), name  # same order, same roundings
    assert kernels.launch_counts() == {
        name: 2 if name in cases else 0 for name in kernels.KERNELS}


def test_table_wrappers_reject_a_foreign_list(device):
    rng, num, BM, blk, rows = _stream(5, 32, True)
    idx, val = _field(rng, num, 11)
    fm = feature_major(idx[:-8], val[:-8], 11)  # built for fewer rows
    xt = FeatureMajor(*(torch.as_tensor(a, device=device) for a in (
        fm.row, fm.val.astype(np.float32), fm.chunk_ptr, fm.feat_ptr)),
        n_rows=fm.n_rows)
    Q1 = torch.randn(num, 32, device=device)
    with pytest.raises(ValueError, match="rows"):
        kernels.grad_self_tbl(xt, Q1, torch.zeros(num, device=device),
                              torch.as_tensor(blk["own"], device=device),
                              torch.zeros(blk["own"].shape, device=device),
                              BM)
    # a table whose row count is not the list's feature count
    fm = feature_major(idx, val, 11)
    xt = FeatureMajor(*(torch.as_tensor(a, device=device) for a in (
        fm.row, fm.val.astype(np.float32), fm.chunk_ptr, fm.feat_ptr)),
        n_rows=fm.n_rows)
    with pytest.raises(ValueError, match="features"):
        kernels.hv_self_tbl(torch.zeros(12, 32, device=device),
                            torch.as_tensor(idx, device=device),
                            torch.as_tensor(val, dtype=torch.float32,
                                            device=device),
                            xt, Q1, torch.ones(num, device=device))


def test_gap_pads_are_exactly_zero(device):
    rng, num, BM, blk, rows = _stream(2, 32, True)
    own = torch.as_tensor(blk["own"], device=device)
    gap = kernels.pos_gap_blocked(
        torch.randn(num, 32, device=device),
        torch.as_tensor(rows, dtype=torch.float32, device=device), own, BM)
    assert torch.all(gap.view(own.shape)[own == BM] == 0)


def test_wrappers_reject_bad_inputs(device):
    rng, num, BM, blk, rows = _stream(3, 32, True)
    own = torch.as_tensor(blk["own"], device=device)
    x = torch.as_tensor(rows, dtype=torch.float32, device=device)
    with pytest.raises(TypeError):
        kernels.pos_gap_blocked(torch.zeros(num, 32, device=device),
                                x.double(), own, BM)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.pos_gap_blocked(torch.zeros(32, num, device=device).T, x,
                                own, BM)
    with pytest.raises(ValueError, match="shape"):
        kernels.pos_scatter_blocked(torch.zeros(3, device=device), x, own,
                                    num, BM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("p", [3, 4, 37])
def test_project_matches_plain(device, dtype, k, p):
    """B8 on a wide table (D = 5000) with duplicate ids, pad slots, pad
    rows and ghost ids (>= D or negative, which add nothing); p = 37 takes
    two 32-slot loads of a row's ids."""
    rng = np.random.default_rng(7)
    num, d = 700, 5000
    idx, val = _field(rng, num, d, p=p)
    idx[::11, 1] = d + 3
    idx[::13, p - 1] = -2

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    x_idx = torch.as_tensor(idx, dtype=torch.int32, device=device)
    W = T(rng.normal(size=(d, k)))
    kernels.reset_launch_counts()
    got = ops.project(x_idx, T(val), W)  # the dispatcher launches on CUDA
    again = kernels.project(x_idx, T(val), W)
    ref = ops.project_plain(x_idx, T(val), W)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (num, k)
    assert torch.equal(got, again)
    assert torch.equal(got, ref)  # same order, same roundings
    assert kernels.launch_counts()["project"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
def test_scatter_matches_plain(device, dtype, k):
    """The general scatter X^T Z on a wide field (D = 5000) with a heavy
    feature split over chunks: bit-equal to its plain version, returned at
    storage dtype."""
    rng = np.random.default_rng(8)
    num, d = 900, 5000
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = FeatureMajor(row=I(fm.row), val=T(fm.val), chunk_ptr=I(fm.chunk_ptr),
                      feat_ptr=I(fm.feat_ptr), n_rows=fm.n_rows)
    Z = T(rng.normal(size=(num, k)))
    kernels.reset_launch_counts()
    got = ops.scatter(xt, Z)
    again = kernels.scatter(xt, Z)
    ref = ops.scatter_plain(xt, Z)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (d, k)
    assert torch.equal(got, again)
    assert torch.equal(got, ref)
    assert kernels.launch_counts()["scatter"] == 2
    with pytest.raises(ValueError, match="rows"):
        kernels.scatter(xt, Z[:-1].contiguous())
