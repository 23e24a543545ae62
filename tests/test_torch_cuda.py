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


def _bits(t):
    """A tensor's bit patterns (torch.equal holds -0.0 equal to +0.0)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


HV_KS = [8, 12, 32, 40, 64, 256]  # both plans of B1 and B4 (common.cuh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", HV_KS)
@pytest.mark.parametrize("sorted_seg", [True, False])
@pytest.mark.parametrize("with_runs", [False, True])
def test_kernels_match_plain(device, dtype, k, sorted_seg, with_runs):
    """The three blocked kernels bit-equal to their plain versions; B1 and
    B2 with the static row runs, or with runs found in the wrapper."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng, num, BM, blk, rows = _stream(1, k, sorted_seg)

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own = torch.as_tensor(blk["own"], device=device)
    x_rows = T(rows)
    phi, dP = T(rng.normal(size=(num, k))), T(rng.normal(size=(num, k)))
    w = T(rng.random(blk["own"].shape) * (blk["own"] < BM))
    c = T(rng.normal(size=blk["own"].shape))
    dense = T(rng.normal(size=(k, k)))
    kw = dict(runs=torch.as_tensor(row_runs(blk["own"], BM), device=device)
              ) if with_runs else {}
    cases = {
        "pos_hv_blocked": ((phi, x_rows, own, w, dense, num, BM, 0.9), kw),
        "pos_scatter_blocked": ((c, x_rows, own, num, BM), kw),
        "pos_gap_blocked": ((dP, x_rows, own, BM), {}),
    }
    kernels.reset_launch_counts()
    for name, (args, kw) in cases.items():
        got = getattr(ops, name)(*args, **kw)  # launches on CUDA
        again = getattr(kernels, name)(*args, **kw)
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
@pytest.mark.parametrize("k", HV_KS)
@pytest.mark.parametrize("sorted_seg", [True, False])
@pytest.mark.parametrize("with_runs", [False, True])
def test_table_kernels_match_plain(device, dtype, k, sorted_seg, with_runs):
    """The four table kernels bit-equal to their plain versions; B4 with
    the static row runs, or with runs found in the wrapper."""
    from one_class_ffm_torch.ops.layout import row_runs

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
    kw = dict(runs=torch.as_tensor(row_runs(blk["own"], BM), device=device)
              ) if with_runs else {}
    cases = {
        "pos_hv_tbl": ((V, x_idx, x_val, xt, x_rows, own, w, dense_mat, BM,
                        0.9), kw),
        "grad_cross_tbl": ((xt, x_rows, own, c, dense, BM), {}),
        "hv_self_tbl": ((V, x_idx, x_val, xt, Q1, dd), {}),
        "grad_self_tbl": ((xt, Q1, zdense, own, c, BM), {}),
    }
    kernels.reset_launch_counts()
    for name, (args, kw) in cases.items():
        got = getattr(ops, name)(*args, **kw)  # launches on CUDA
        again = getattr(kernels, name)(*args, **kw)
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
@pytest.mark.parametrize("k", [8, 32, 40, 64, 128, 256])
@pytest.mark.parametrize("p", [3, 4, 37])
@pytest.mark.parametrize("d", [5000, 201_000])
def test_project_matches_plain(device, dtype, k, p, d):
    """B8 on wide tables (D = 5000, and FM's user-field width 201,000) with
    duplicate ids, pad slots, pad rows and ghost ids (>= D or negative,
    which add nothing), on every width plan (k = 64 to 256: the wide vector
    plans; k = 40 at bfloat16 is 80 bytes a row, 16-byte vectors too); p =
    37 takes ten batches of a row's slots."""
    rng = np.random.default_rng(7)
    num = 700
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
    assert torch.equal(_bits(got), _bits(ref))  # signs of zero too
    assert kernels.launch_counts()["project"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40, 64])
def test_hv_self_tbl_matches_plain_bits(device, dtype, k):
    """B6 (its group-per-row scale stage, then the X^T stage forming
    storage(s * Q1[row]) per entry) bit-equal to hv_self_tbl_plain, signs
    of zero included, on both width plans (k <= 32: 16-byte vectors; 40
    and 64: the plain-load plan), with -0.0 in V and Q1 (the dot's tree
    adds +0 where a partner is past k or past the group), ghost ids in X's
    rows (the projection drops them), all-pad rows, dd = 0 rows, and equal
    on repeat."""
    rng = np.random.default_rng(16)
    num, d = 900, 37
    idx, val = _field(rng, num, d, p=4)
    fm = feature_major(idx, val, d)
    idx[::11, 1] = d + 3  # ghosts: in X's rows, not in the list
    idx[::13, 3] = -2
    V_np = rng.normal(size=(d, k))
    V_np[::3] = -0.0
    Q1_np = rng.normal(size=(num, k))
    Q1_np[rng.random(Q1_np.shape) < 0.2] = -0.0
    Q1_np[:8] = -0.0
    dd_np = rng.random(num) * 5
    dd_np[::9] = 0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = _device_list(fm, T, I)
    args = (T(V_np), I(idx), T(val), xt, T(Q1_np), T(dd_np))
    kernels.reset_launch_counts()
    got = ops.hv_self_tbl(*args)  # the dispatcher launches on CUDA
    again = kernels.hv_self_tbl(*args)
    ref = ops.hv_self_tbl_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (d, k)
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(got), _bits(ref)), (k, dtype)
    assert kernels.launch_counts()["hv_self_tbl"] == 2
    with pytest.raises(ValueError, match="scale"):
        kernels._xt_scatter(kernels.load(), args[4], xt, "hv_self_tbl",
                            scale=args[5][:-1].contiguous())


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


# ---------------------------------------------------------------------------
# the Jacobi diagonal's outputs (B2, B5, B7 with_diag) and the Hv variants
# of hv_pack_bench (B9, B10)
# ---------------------------------------------------------------------------


def _squared(xt):
    return xt._replace(val_sq=xt.val * xt.val)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
def test_diag_kernels_match_plain(device, dtype, k):
    """The three gradient passes with the Jacobi output: one launch each,
    both outputs bit-equal to the plain versions, and the first output
    bit-equal to the pass without the diagonal."""
    rng, num, BM, blk, rows = _stream(9, k, False)
    d = 37
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = _squared(FeatureMajor(row=I(fm.row), val=T(fm.val),
                               chunk_ptr=I(fm.chunk_ptr),
                               feat_ptr=I(fm.feat_ptr), n_rows=fm.n_rows))
    own = I(blk["own"])
    x_rows = T(rows)
    w = T(rng.random(blk["own"].shape) * (blk["own"] < BM))
    c = T(rng.normal(size=blk["own"].shape))
    Q1 = T(rng.normal(size=(num, k)))
    dense = T(rng.normal(size=(num, k)))
    dd, zdense = T(rng.random(num) * 5), T(rng.normal(size=num))
    cases = {
        "pos_scatter_blocked": ((c, x_rows, own, num, BM),
                                dict(w_blk=w, wq_scale=0.9)),
        "grad_cross_tbl": ((xt, x_rows, own, c, dense, BM),
                           dict(w_blk=w, wq_scale=0.9)),
        "grad_self_tbl": ((xt, Q1, zdense, own, c, BM), dict(dd=dd)),
    }
    kernels.reset_launch_counts()
    for name, (args, kw) in cases.items():
        got = getattr(ops, name)(*args, **kw)  # dispatches to the _diag kernel
        again = getattr(kernels, name + "_diag")(*args, *kw.values())
        ref = getattr(ops, name + "_plain")(*args, **kw)
        alone = getattr(kernels, name)(*args)
        torch.cuda.synchronize()
        for g, a, r in zip(got, again, ref):
            assert g.shape == r.shape and g.dtype == r.dtype, name
            assert torch.equal(g, a), f"{name}: launches differ"
            assert _max_rel(g, r) <= BOUND[dtype], name
            assert torch.equal(g, r), name  # same order, same roundings
        assert torch.equal(got[0], alone), name
    assert kernels.launch_counts() == {
        name: 2 if name.endswith("_diag") else 1 if name in cases else 0
        for name in kernels.KERNELS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_squared_scatter_matches_plain(device, dtype):
    rng = np.random.default_rng(10)
    num, d = 600, 5000
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)
    T = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)  # noqa
    xt = _squared(FeatureMajor(
        row=torch.as_tensor(fm.row, device=device), val=T(fm.val),
        chunk_ptr=torch.as_tensor(fm.chunk_ptr, device=device),
        feat_ptr=torch.as_tensor(fm.feat_ptr, device=device),
        n_rows=fm.n_rows))
    Z = T(rng.normal(size=(num, 32))).contiguous()
    got = ops.scatter(xt, Z, squared=True)
    assert torch.equal(got, ops.scatter_plain(xt, Z, squared=True))
    assert not torch.equal(got, ops.scatter(xt, Z))
    with pytest.raises(ValueError, match="val_sq"):
        kernels.scatter(xt._replace(val_sq=None), Z, squared=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_hv_variants_match_b1(device, dtype, groups):
    """B9 on the packed stream and B10 at G blocks per CTA, both given the
    static row runs, give B1's bits and their plain versions' bits."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(11)
    nb, maxc, BM, k = 8, 64, 32, 32
    own = np.sort(rng.integers(0, BM + 1, size=(nb, maxc)), axis=1)
    w = (own < BM) * rng.random((nb, maxc))

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own_t = torch.as_tensor(own, dtype=torch.int32, device=device)
    rows, w_t = T(rng.normal(size=(nb, maxc, k))), T(w)
    phi, dmat = T(rng.normal(size=(nb * BM, k))), T(rng.normal(size=(k, k)))
    rows_p, own_p, w_p = ops.pack_rows(rows, own_t, w_t)
    runs = torch.as_tensor(row_runs(own, BM), device=device)
    kernels.reset_launch_counts()
    b1 = kernels.pos_hv_blocked(phi, rows, own_t, w_t, dmat, nb * BM, BM, 0.9)
    b9 = ops.pos_hv_packed(phi, rows_p, own_p, w_p, dmat, nb * BM, BM, 0.9,
                           runs=runs)
    b10 = ops.pos_hv_blocked_g(phi, rows, own_t, w_t, dmat, nb * BM, BM,
                               groups, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(b9, b1) and torch.equal(b10, b1)
    assert torch.equal(b9, ops.pos_hv_packed_plain(
        phi, rows_p, own_p, w_p, dmat, nb * BM, BM, 0.9))
    assert torch.equal(b10, ops.pos_hv_blocked_g_plain(
        phi, rows, own_t, w_t, dmat, nb * BM, BM, groups, 0.9))
    counts = kernels.launch_counts()
    assert counts["pos_hv_packed"] == 1 and counts["pos_hv_blocked_g"] == 1
    with pytest.raises(ValueError, match="divide"):
        kernels.pos_hv_blocked_g(phi, rows, own_t, w_t, dmat, nb * BM, BM, 3)


# ---------------------------------------------------------------------------
# the redesigned X^T stage (single-chunk features written directly, groups
# of lanes per chunk, widths fixed at compile time) and B2 (row runs, bulk
# copies into shared-memory stages, the plain-load path for other k)
# ---------------------------------------------------------------------------


def _xt_field(rng, num=700, d=300):
    """A field (num, 2) whose list holds a feature with exactly XT_CHUNK
    entries (0), one with many chunks (1), one-entry features (2..184),
    features of a few entries (185..249), featureless ones (250..299) and
    pad slots."""
    from one_class_ffm_torch.ops.layout import XT_CHUNK

    idx = np.zeros((num, 2), np.int32)
    idx[:XT_CHUNK, 0] = 0
    heavy = 3 * XT_CHUNK + 5
    idx[XT_CHUNK:XT_CHUNK + heavy, 0] = 1
    rest = num - XT_CHUNK - heavy
    idx[XT_CHUNK + heavy:, 0] = 2 + np.arange(rest)
    idx[:, 1] = rng.integers(2 + rest, 250, size=num)
    val = rng.uniform(0.5, 1.5, size=(num, 2))
    val[rng.random(num) < 0.3, 1] = 0.0  # pad slots
    idx[val == 0] = 0
    return idx, val, d


def _device_list(fm, T, I):
    return FeatureMajor(row=I(fm.row), val=T(fm.val),
                        chunk_ptr=I(fm.chunk_ptr), feat_ptr=I(fm.feat_ptr),
                        n_rows=fm.n_rows, combine=I(fm.combine),
                        chunk_dst=I(fm.chunk_dst), slot_feat=I(fm.slot_feat))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 12, 32, 40, 256])
@pytest.mark.parametrize("field", ["mixed", "all_single"])
def test_xt_stage_matches_plain(device, dtype, k, field):
    """The X^T stage (the general scatter, through X and X^2) bit-equal to
    its plain version at widths on both paths (k = 12 at bfloat16 is 24
    bytes a row: the plain-load path), on a list with every kind of
    feature, and on one whose features all have a single chunk; the plan
    derived in the wrapper gives the same bits as the list's own."""
    rng = np.random.default_rng(13)
    if field == "mixed":
        idx, val, d = _xt_field(rng)
    else:
        num = d = 500
        idx = rng.permutation(num).astype(np.int32)[:, None]
        val = rng.uniform(0.5, 1.5, size=(num, 1))
    fm = feature_major(idx, val, d)
    nch = np.diff(fm.feat_ptr)
    if field == "mixed":
        assert nch[0] == 1 and nch[1] == 4 and (nch == 0).sum() >= 50
    else:
        assert fm.combine.size == 0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = _squared(_device_list(fm, T, I))
    Z = T(rng.normal(size=(idx.shape[0], k)))
    kernels.reset_launch_counts()
    for squared in (False, True):
        got = ops.scatter(xt, Z, squared)
        again = kernels.scatter(xt, Z, squared)
        derived = kernels.scatter(xt._replace(combine=None), Z, squared)
        ref = ops.scatter_plain(xt, Z, squared)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (d, k)
        assert torch.equal(got, again) and torch.equal(got, derived)
        assert torch.equal(got, ref), (k, squared)
        assert torch.all(got[torch.as_tensor(nch == 0, device=device)] == 0)
    assert kernels.launch_counts()["scatter"] == 6


def _b2_stream(rng, k, maxc_pad):
    """Four blocks of 64 rows: short runs with empty rows between them, a
    block of pads only, a block with one run far longer than a shared-memory
    stage, and random runs; MAXC rounded up to 8 plus ``maxc_pad`` (a MAXC
    that is not a multiple of 8 takes the plain-load path)."""
    BM = 64
    counts = np.zeros((4, BM), np.int64)
    counts[0] = rng.choice([0, 0, 1, 3], size=BM)
    counts[2] = rng.integers(0, 3, size=BM)
    counts[2, 5] = 700
    counts[3] = rng.integers(0, 12, size=BM)
    maxc = -(-int(counts.sum(axis=1).max()) // 8) * 8 + maxc_pad
    own = np.full((4, maxc), BM, np.int32)
    for b in range(4):
        run = np.repeat(np.arange(BM), counts[b])
        own[b, :run.size] = run
    return own, BM, rng.normal(size=(4, maxc, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [12, 32, 40])
@pytest.mark.parametrize("maxc_pad", [0, 3])
def test_b2_runs_and_stages_match_plain(device, dtype, k, maxc_pad):
    """B2 and its Jacobi variant bit-equal to their plain versions on empty
    rows, a block of pads only, a run longer than one stage and the
    plain-load path (k = 12 at bfloat16, or MAXC % 8 != 0), with the static
    runs and with runs found in the wrapper."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(14)
    own_np, BM, rows_np = _b2_stream(rng, k, maxc_pad)

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own = torch.as_tensor(own_np, device=device)
    runs = torch.as_tensor(row_runs(own_np, BM), device=device)
    rows = T(rows_np)
    c = T(rng.normal(size=own_np.shape) * (own_np < BM))
    w = T(rng.random(own_np.shape) * (own_np < BM))
    num = 4 * BM
    kernels.reset_launch_counts()
    got = ops.pos_scatter_blocked(c, rows, own, num, BM, runs=runs)
    derived = kernels.pos_scatter_blocked(c, rows, own, num, BM)
    ref = ops.pos_scatter_blocked_plain(c, rows, own, num, BM)
    gd = ops.pos_scatter_blocked(c, rows, own, num, BM, w_blk=w,
                                 wq_scale=0.9, runs=runs)
    gd2 = kernels.pos_scatter_blocked_diag(c, rows, own, num, BM, w, 0.9)
    rd = ops.pos_scatter_blocked_plain(c, rows, own, num, BM, w_blk=w,
                                       wq_scale=0.9)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (num, k)
    assert torch.equal(got, derived) and torch.equal(got, ref)
    for g, g2, r in zip(gd, gd2, rd):
        assert torch.equal(g, g2) and torch.equal(g, r)
    assert torch.equal(gd[0], got)
    assert torch.all(got[BM:2 * BM] == 0)  # the block of pads only
    empty = torch.as_tensor(np.diff(row_runs(own_np, BM), axis=1).ravel()
                            == 0, device=device)
    assert torch.all(got[empty] == 0) and torch.all(gd[1][empty] == 0)
    counts = kernels.launch_counts()
    assert counts["pos_scatter_blocked"] == 2
    assert counts["pos_scatter_blocked_diag"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.pos_scatter_blocked(c, rows, own, num, BM,
                                    runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [12, 32, 40])
@pytest.mark.parametrize("maxc_pad", [0, 3])
def test_hv_runs_and_stages_match_plain(device, dtype, k, maxc_pad):
    """B1 and B4 bit-equal to their plain versions on B2's edge cases (empty
    rows, a block of pads only, a run of 700 slots over many shared-memory
    stages, MAXC % 8 != 0 on the plain-load path), with phi and the table
    holding -0.0 and the stream exact zeros (the signed-zero rule of the
    dot's tree), with the static runs and with runs found in the wrapper:
    the bit patterns equal, signs of zero included."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(15)
    own_np, BM, rows_np = _b2_stream(rng, k, maxc_pad)
    num, d = 4 * BM, 23
    rows_np[rng.random(rows_np.shape) < 0.2] = 0.0
    phi_np = rng.normal(size=(num, k))
    phi_np[rng.random(phi_np.shape) < 0.2] = -0.0
    phi_np[:8] = -0.0
    idx, val = _field(rng, num, d)
    V_np = rng.normal(size=(d, k))
    V_np[::3] = -0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    fm = feature_major(idx, val, d)
    xt = FeatureMajor(row=I(fm.row), val=T(fm.val), chunk_ptr=I(fm.chunk_ptr),
                      feat_ptr=I(fm.feat_ptr), n_rows=fm.n_rows)
    own, runs = I(own_np), I(row_runs(own_np, BM))
    rows, phi, V = T(rows_np), T(phi_np), T(V_np)
    w = T(rng.random(own_np.shape) * (own_np < BM))
    dense = T(rng.normal(size=(k, k)))
    b1 = (phi, rows, own, w, dense, num, BM, 0.9)
    b4 = (V, I(idx), T(val), xt, rows, own, w, dense, BM, 0.9)
    kernels.reset_launch_counts()
    for name, args in (("pos_hv_blocked", b1), ("pos_hv_tbl", b4)):
        got = getattr(ops, name)(*args, runs=runs)
        derived = getattr(kernels, name)(*args)
        ref = getattr(ops, name + "_plain")(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, derived) and torch.equal(got, ref), name
        assert torch.equal(_bits(got), _bits(ref)), name  # signs of zero too
    counts = kernels.launch_counts()
    assert counts["pos_hv_blocked"] == 2 and counts["pos_hv_tbl"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.pos_hv_blocked(*b1, runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 16, 32, 64])
@pytest.mark.parametrize("maxc_pad", [0, 3])
def test_gap_staged_and_plain_load_match_plain_bits(device, dtype, k,
                                                    maxc_pad):
    """B3 on the staged path (k <= 32, MAXC % 8 == 0) and the plain-load
    path (k = 64, or MAXC % 8 != 0), with the static runs and with runs
    found in the wrapper: bit patterns equal to pos_gap_blocked_plain's,
    signs of zero included (dP holding -0.0, the stream exact zeros), on
    B2's edge cases (empty rows, a block of pads only, a run of 700 slots
    over many stages); every slot is written, the pads exactly +0, into a
    buffer filled with NaN before the launch; equal on repeat."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(18)
    own_np, BM, rows_np = _b2_stream(rng, k, maxc_pad)
    num = 4 * BM
    rows_np[rng.random(rows_np.shape) < 0.2] = 0.0
    dP_np = rng.normal(size=(num, k))
    dP_np[rng.random(dP_np.shape) < 0.2] = -0.0
    dP_np[:8] = -0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own = torch.as_tensor(own_np, device=device)
    runs = torch.as_tensor(row_runs(own_np, BM), device=device)
    rows, dP = T(rows_np), T(dP_np)
    kernels.reset_launch_counts()
    got = ops.pos_gap_blocked(dP, rows, own, BM, runs=runs)
    derived = kernels.pos_gap_blocked(dP, rows, own, BM)
    ref = ops.pos_gap_blocked_plain(dP, rows, own, BM)
    nan = torch.full((own.numel(),), float("nan"), dtype=dtype,
                     device=device)
    kernels._gap_into(nan, dP, rows, own, BM, runs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    for g in (got, derived, nan):
        assert torch.equal(_bits(g), _bits(ref)), (k, maxc_pad, dtype)
    pads = torch.as_tensor(own_np.ravel() == BM, device=device)
    assert not torch.any(torch.signbit(nan[pads])) and torch.all(
        nan[pads] == 0)
    assert torch.all(nan.view(own.shape)[1] == 0)  # the block of pads only
    assert kernels.launch_counts()["pos_gap_blocked"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.pos_gap_blocked(dP, rows, own, BM,
                                runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 64])
def test_grad_self_tbl_matches_plain_bits(device, dtype, k):
    """B7 and its Jacobi variant (the row stage's zb per row from its run
    of coefficients, then the X^T stage forming storage(zb * Q1[row]) per
    entry, and storage(storage(dd * Q1[row]) * Q1[row]) per entry through
    X^2) bit-equal to grad_self_tbl_plain, signs of zero included, on B2's
    edge cases (empty rows, a block of pads only, a run of 700 slots), with
    -0.0 in Q1, zdense and the coefficients, dd = 0 rows, features of one
    chunk, several and none, with the static runs and with runs found in
    the wrapper, and equal on repeat."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(19)
    own_np, BM, _ = _b2_stream(rng, k, 0)
    num, d = 4 * BM, 37
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)
    Q1_np = rng.normal(size=(num, k))
    Q1_np[rng.random(Q1_np.shape) < 0.2] = -0.0
    c_np = rng.normal(size=own_np.shape) * (own_np < BM)
    c_np[rng.random(c_np.shape) < 0.1] = -0.0
    zdense_np = rng.normal(size=num)
    zdense_np[::6] = -0.0
    dd_np = rng.random(num) * 5
    dd_np[::9] = 0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = _squared(_device_list(fm, T, I))
    own, runs = I(own_np), I(row_runs(own_np, BM))
    args = (xt, T(Q1_np), T(zdense_np), own, T(c_np), BM)
    dd = T(dd_np)
    kernels.reset_launch_counts()
    got = ops.grad_self_tbl(*args, runs=runs)
    derived = kernels.grad_self_tbl(*args)
    ref = ops.grad_self_tbl_plain(*args)
    gd = ops.grad_self_tbl(*args, dd=dd, runs=runs)
    gd2 = kernels.grad_self_tbl_diag(*args, dd)
    rd = ops.grad_self_tbl_plain(*args, dd=dd)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (d, k)
    for g in (got, derived, gd[0], gd2[0]):
        assert torch.equal(_bits(g), _bits(ref)), (k, dtype)
    for g in (gd[1], gd2[1]):
        assert torch.equal(_bits(g), _bits(rd[1])), (k, dtype)
    counts = kernels.launch_counts()
    assert counts["grad_self_tbl"] == 2 and counts["grad_self_tbl_diag"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.grad_self_tbl(*args, runs=runs[:, :-1].contiguous())
    with pytest.raises(ValueError, match="scale"):
        kernels._xt_scatter(kernels.load(), args[1], xt, "grad_self_tbl",
                            True, payload_sq=True)


# ---------------------------------------------------------------------------
# B5's row stage on B2's runs-and-stages body, and B10 on B1's stage loop
# with one ring across its G blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 48])
@pytest.mark.parametrize("maxc_pad", [0, 3])
def test_b5_runs_and_stages_match_plain(device, dtype, k, maxc_pad):
    """B5 and its Jacobi variant bit-equal to grad_cross_tbl_plain, signs of
    zero included, on B2's edge cases (empty rows, a block of pads only, a
    run of 700 slots over many stages, MAXC % 8 != 0 on the plain-load
    plan), with -0.0 in the coefficients and the dense rows, with the
    static runs and with runs found in the wrapper; the gradient output
    equals the pass without the diagonal; equal on repeat."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(20)
    own_np, BM, rows_np = _b2_stream(rng, k, maxc_pad)
    num, d = 4 * BM, 37
    rows_np[rng.random(rows_np.shape) < 0.2] = 0.0
    idx, val = _field(rng, num, d)
    fm = feature_major(idx, val, d)
    c_np = rng.normal(size=own_np.shape) * (own_np < BM)
    c_np[rng.random(c_np.shape) < 0.1] = -0.0
    dense_np = rng.normal(size=(num, k))
    dense_np[rng.random(dense_np.shape) < 0.2] = -0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    def I(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    xt = _squared(_device_list(fm, T, I))
    own, runs = I(own_np), I(row_runs(own_np, BM))
    w = T(rng.random(own_np.shape) * (own_np < BM))
    args = (xt, T(rows_np), own, T(c_np), T(dense_np), BM)
    kernels.reset_launch_counts()
    got = ops.grad_cross_tbl(*args, runs=runs)
    derived = kernels.grad_cross_tbl(*args)
    ref = ops.grad_cross_tbl_plain(*args)
    gd = ops.grad_cross_tbl(*args, w_blk=w, wq_scale=0.9, runs=runs)
    gd2 = kernels.grad_cross_tbl_diag(*args, w, 0.9)
    rd = ops.grad_cross_tbl_plain(*args, w_blk=w, wq_scale=0.9)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (d, k)
    for g in (got, derived, gd[0], gd2[0]):
        assert torch.equal(_bits(g), _bits(ref)), (k, maxc_pad, dtype)
    for g in (gd[1], gd2[1]):
        assert torch.equal(_bits(g), _bits(rd[1])), (k, maxc_pad, dtype)
    counts = kernels.launch_counts()
    assert counts["grad_cross_tbl"] == 2
    assert counts["grad_cross_tbl_diag"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.grad_cross_tbl(*args, runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_b10_ring_matches_b1_and_plain(device, dtype, k, groups):
    """B10 at G blocks per CTA bit-equal to B1 and to its plain version,
    signs of zero included, on B2's edge cases (a block of pads only, whose
    CTAs add no stage to the ring, a run of 700 slots over many stages,
    empty rows), on the staged plans (k = 8, 32) and the plain-load plan (k
    = 40), with the static runs and with runs found in the wrapper; a G
    that does not divide n_blocks is refused."""
    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(21)
    own_np, BM, rows_np = _b2_stream(rng, k, 0)
    num = 4 * BM
    rows_np[rng.random(rows_np.shape) < 0.2] = 0.0
    phi_np = rng.normal(size=(num, k))
    phi_np[rng.random(phi_np.shape) < 0.2] = -0.0
    phi_np[:8] = -0.0

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    own = torch.as_tensor(own_np, dtype=torch.int32, device=device)
    runs = torch.as_tensor(row_runs(own_np, BM), device=device)
    w = T(rng.random(own_np.shape) * (own_np < BM))
    args = (T(phi_np), T(rows_np), own, w, T(rng.normal(size=(k, k))), num,
            BM)
    kernels.reset_launch_counts()
    b1 = kernels.pos_hv_blocked(*args, 0.9, runs=runs)
    got = ops.pos_hv_blocked_g(*args, groups, 0.9, runs=runs)
    derived = kernels.pos_hv_blocked_g(*args, groups, 0.9)
    ref = ops.pos_hv_blocked_g_plain(*args, groups, 0.9)
    torch.cuda.synchronize()
    for g in (got, derived, b1):
        assert torch.equal(_bits(g), _bits(ref)), (k, groups, dtype)
    assert kernels.launch_counts()["pos_hv_blocked_g"] == 2
    with pytest.raises(ValueError, match="divide"):
        kernels.pos_hv_blocked_g(*args, 3, 0.9, runs=runs)
    with pytest.raises(ValueError, match="runs"):
        kernels.pos_hv_blocked_g(*args, groups, 0.9,
                                 runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxc", [64, 40, 1240])
def test_b9_staged_windows_match_b1(device, dtype, maxc):
    """B9's tensor-map stages on packed streams whose MAXC/4 is a multiple
    of 8 (64) and is not (40, 1240), with CTA spans over 0 to 3 lane-group
    boundaries, a block of pads only, empty row slices and signed zeros
    (tests/test_torch_hv_packed_staged.py's streams): bit-equal to B1 and
    to its plain version, with the static runs and with runs found in the
    wrapper; wrong runs are refused."""
    from test_torch_hv_packed_staged import BM as PBM
    from test_torch_hv_packed_staged import W_SCALE, packed_stream

    from one_class_ffm_torch.ops.layout import row_runs

    rng = np.random.default_rng(100 + maxc)
    (phi, rows, own, w, dmat), (rows_p, own_p, w_p) = packed_stream(
        rng, maxc, dtype)
    runs = torch.as_tensor(row_runs(own.numpy(), PBM), device=device)
    phi, rows, own, w, dmat, rows_p, own_p, w_p = (
        t.to(device).contiguous()
        for t in (phi, rows, own, w, dmat, rows_p, own_p, w_p))
    num = own.shape[0] * PBM
    kernels.reset_launch_counts()
    b1 = kernels.pos_hv_blocked(phi, rows, own, w, dmat, num, PBM, W_SCALE,
                                runs=runs)
    got = ops.pos_hv_packed(phi, rows_p, own_p, w_p, dmat, num, PBM,
                            W_SCALE, runs=runs)
    derived = kernels.pos_hv_packed(phi, rows_p, own_p, w_p, dmat, num, PBM,
                                    W_SCALE)
    ref = ops.pos_hv_packed_plain(phi, rows_p, own_p, w_p, dmat, num, PBM,
                                  W_SCALE)
    torch.cuda.synchronize()
    for g in (got, derived, b1):
        assert torch.equal(_bits(g), _bits(ref)), (maxc, dtype)
    assert kernels.launch_counts()["pos_hv_packed"] == 2
    with pytest.raises(ValueError, match="runs"):
        kernels.pos_hv_packed(phi, rows_p, own_p, w_p, dmat, num, PBM,
                              W_SCALE, runs=runs[:, :-1].contiguous())


@pytest.mark.parametrize("name", ["rows_p", "w_p", "phi", "dense_mat"])
def test_b9_refuses_an_unaligned_base(device, name):
    """The tensor maps need 16-byte-aligned bases (and phi, dense are read
    as 16-byte vectors): a contiguous tensor that starts 4 bytes into its
    storage is refused, not copied or read by another path."""
    rng = np.random.default_rng(5)
    nb, maxc, BM = 2, 40, 8
    own = np.sort(rng.integers(0, BM + 1, size=(nb, maxc)), axis=1)
    own_t = torch.as_tensor(own, dtype=torch.int32, device=device)
    rows = torch.randn(nb, maxc, 32, device=device)
    w = torch.rand(nb, maxc, device=device) * (own_t < BM)
    rows_p, own_p, w_p = ops.pack_rows(rows, own_t, w)
    args = dict(phi=torch.randn(nb * BM, 32, device=device), rows_p=rows_p,
                own_p=own_p, w_p=w_p,
                dense_mat=torch.randn(32, 32, device=device))
    t = args[name]
    shifted = torch.empty(t.numel() + 1, device=device)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args[name] = shifted
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.pos_hv_packed(args["phi"], args["rows_p"], own_p,
                              args["w_p"], args["dense_mat"], nb * BM, BM)


# ---------------------------------------------------------------------------
# the two-tier head tier on the card
# ---------------------------------------------------------------------------


def _skewed_solvers(device, cg_precond="none", dtype=torch.float32):
    """One skewed FFM (zipf 1.0 item popularity, an id and a small feature
    field per side, self blocks; 8 rows per block and 8-slot chunks, so the
    v side takes the head tier) as solvers on the CPU and on the card, from
    one set of tables."""
    from one_class_ffm_torch.data.synth import SynthSpec, build_padded
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.solver import torch_solver
    from one_class_ffm_torch.solver.params import HyperParams

    spec = SynthSpec(n_users=600, n_items=120, dims_u=(600, 30),
                     dims_v=(120, 20), avg_pos=5.0, seed=1, pop_skew=1.0)
    (du, dv), u, v, y = build_padded(spec, np.float32, row_multiple=8)
    hp = HyperParams(k=32, lam=0.05, omega=0.1, r=-1.0,
                     cg_precond=cg_precond)
    out = []
    for dev in ("cpu", device):
        meta, data = torch_solver.make_device_data(
            u, v, y, BlockLayout.make(du, dv, True), hp, dtype=dtype,
            blocked_bm=8, head_chunk=8, device=dev)
        out.append(torch_solver.FFMSolver(meta, data))
    assert all(s.hd_v for s in out)
    state = out[0].init(torch.Generator().manual_seed(0))
    params = {f: {n: t.to(device) for n, t in blk.items()}
              for f, blk in state["params"].items()}
    return out, (state, out[1].refresh_caches({"params": params}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_ops_on_the_card_match_the_cpu(device, dtype):
    """Each head op on the card (batched products, the chunk table's row
    sums, B8 and the X^T stage for the fused terms) against the same op on
    the CPU: sums in other orders, so max-rel within the kernels' bound."""
    (cpu, gpu), (cst, gst) = _skewed_solvers(device, dtype=dtype)
    nch = cpu.data["blk_v_hd_take"].shape[0]
    fu = cpu.meta.layout.fu  # the two feature fields' cross block
    b = next(b for b in cpu.blocks if (b.f1, b.f2) == (1, fu + 1))
    results = []
    for solver, st in ((cpu, cst), (gpu, gst)):
        d = solver.data
        B1 = st["P"][b.f12]
        rows_hd = ops.gather_blocked_rows(B1, d["blk_v_hd_take"])
        phi = st["Q"][b.f12]
        c = solver._hd_coeff(st, False)
        args = (d["blk_v_hd_tab"], d["blk_v_hd_rows"])
        results.append(dict(
            chunk_sums=ops.head_chunk_sums(c, rows_hd),
            pq=ops.head_pq(phi.index_select(0, d["blk_v_hd_row"]), rows_hd),
            seg_sum=ops.head_seg_sum(c, *args, solver.meta.n),
            scatter=ops.head_scatter(c, rows_hd, *args, solver.meta.n,
                                     diag_w_hd=d["blk_v_hd_w"])[1],
            hv=ops.head_hv(phi, rows_hd, solver._hd_wq["v"],
                           d["blk_v_hd_row"], *args, solver.meta.n),
            hv_tbl=solver._hd_hv_tbl(b, False, st["params"][b.f12]["H"],
                                     rows_hd),
            tbl=solver._hd_tbl(st, b, False, rows_hd, with_diag=True)[1]))
    assert results[0]["chunk_sums"].shape[0] == nch
    for name, ref in results[0].items():
        got = results[1][name]
        assert got.device.type == torch.device(device).type, name
        assert got.dtype == ref.dtype, name
        assert _max_rel(got.cpu(), ref) <= BOUND[dtype], name


@pytest.mark.parametrize("cg_precond", ["none", "jacobi"])
def test_two_tier_solver_on_the_card_matches_the_cpu(device, cg_precond):
    """The skewed FFM's gradient, Hv and (Jacobi) diagonal of every block
    side on the card against the CPU's plain path; one epoch on the card
    run twice from one state gives the same bits, and its carried head
    residual equals a fresh ``refresh_caches``."""
    (cpu, gpu), (cst, gst) = _skewed_solvers(device, cg_precond)
    sa_c, sb_c = cpu.sasb(cst)
    sa_g, sb_g = gpu.sasb(gst)
    rng = np.random.default_rng(2)
    for b in cpu.blocks:
        for first in (True, False):
            Gc, hvc, _, _, Dc = cpu.solve_inputs(cst, b, first, sa_c, sb_c)
            Gg, hvg, _, _, Dg = gpu.solve_inputs(gst, b, first, sa_g, sb_g)
            V = torch.as_tensor(rng.normal(size=tuple(Gc.shape)),
                                dtype=torch.float32)
            pairs = [(Gg, Gc), (hvg(V.to(device)), hvc(V))]
            if cg_precond == "jacobi":
                pairs.append((Dg, Dc))
            for got, ref in pairs:
                assert _max_rel(got.cpu(), ref) <= 1e-4, (b.f12, first)
    kernels.reset_launch_counts()
    g1, it1 = gpu.epoch_stats(gst)
    assert sum(kernels.launch_counts().values()) > 0
    g2, it2 = gpu.epoch_stats(gst)
    assert torch.equal(it1, it2)
    for key in ("yt_u", "yt_v", "yt_v_hd", "a", "b"):
        assert torch.equal(_bits(g1[key]), _bits(g2[key])), key
    re = gpu.refresh_caches({"params": g1["params"]})
    for key in ("yt_v", "yt_v_hd"):
        assert _max_rel(g1[key].cpu(), re[key].cpu()) <= 1e-4, key


# ---------------------------------------------------------------------------
# the COO positive passes and pos_dot on the card
# ---------------------------------------------------------------------------


def _coo_stream(device, dtype, k, sorted_seg, chunk):
    """A stream of 700 rows x 300 other rows: a power row with 3,000
    entries (24 chunks of the default 128, 375 of 8), rows without
    entries, 50 pad entries with ghost ids; the list (its weights in list
    order), the coefficients, the weights in stream order and the table on
    the card."""
    from one_class_ffm_torch.ops.layout import coo_list

    rng = np.random.default_rng(7)
    num, n_other, nnz = 700, 300, 6000
    seg = rng.integers(0, num - 40, size=nnz)
    seg[:3000] = 5
    if sorted_seg:
        seg = np.sort(seg)
    else:
        seg = seg[rng.permutation(nnz)]
    take = rng.integers(0, n_other, size=nnz)
    seg = np.concatenate([seg, np.full(50, num)]).astype(np.int32)
    take = np.concatenate([take, np.full(50, n_other)]).astype(np.int32)
    w = np.concatenate([np.ones(nnz), np.zeros(50)])
    lst = coo_list(seg, take, w != 0, num, n_other, chunk=chunk)
    coo = lst._replace(**{f: torch.as_tensor(getattr(lst, f), device=device)
                          for f in ("row", "chunk_ptr", "feat_ptr",
                                    "combine", "chunk_dst", "slot_feat",
                                    "pos")})

    def T(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    wq = T(rng.uniform(0.5, 1.5, size=w.size) * w)
    return (coo._replace(val=wq[coo.pos.long()]),
            T(rng.normal(size=w.size) * w), wq,
            T(rng.normal(size=(n_other, k))))


def _coo_calls(coo, c, B, phi):
    """Each COO kernel's outputs on one list (the pair, the squared-only
    form, the width-1 sums in the list's own plan and in both, the fused Hv
    at the scales of omega = 0.1)."""
    return {
        "pos_scatter": (kernels.pos_scatter(c, B, coo),),
        "pos_scatter_pair": kernels.pos_scatter_pair(c, B, coo, 0.9),
        "pos_scatter_sq": kernels.pos_scatter_pair(None, B, coo, 0.9)[1:],
        "pos_seg_sum": (kernels.pos_seg_sum(c, coo),),
        "pos_seg_sum 1": (kernels.pos_seg_sum(c, coo, lanes=1),),
        "pos_seg_sum 8": (kernels.pos_seg_sum(c, coo, lanes=8),),
        "pos_hv_coo": (kernels.pos_hv_coo(phi, B, coo, 0.9),),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 12, 32, 40, 256])
@pytest.mark.parametrize("sorted_seg", [True, False])
@pytest.mark.parametrize("chunk", [8, 128])
def test_coo_kernels_match_plain_bits(device, dtype, k, sorted_seg, chunk):
    """The list pass's sources bit-equal to the plain versions:
    ``pos_scatter``, both outputs of ``pos_scatter_pair`` (one launch) and
    its squared-only form, the width-1 ``pos_seg_sum`` (its list's plan, a
    lane and 8 lanes a chunk) and the fused Hv
    ``pos_hv_coo``; a repeat gives the same bits; a power row spanning
    hundreds of chunks is finished in chunk order; each wrapper counts one
    launch per call."""
    coo, c, wq, B = _coo_stream(device, dtype, k, sorted_seg, chunk)
    phi = torch.randn((coo.feat_ptr.numel() - 1, k), device=device,
                      generator=torch.Generator(device).manual_seed(3)
                      ).to(dtype)
    kernels.reset_launch_counts()
    got = _coo_calls(coo, c, B, phi)
    counts = kernels.launch_counts()
    assert counts["pos_scatter_pair"] == 2, counts
    assert counts["pos_seg_sum"] == 3, counts
    assert all(counts[name] == 1 for name in ("pos_scatter",
                                              "pos_hv_coo")), counts
    again = _coo_calls(coo, c, B, phi)
    ref = {
        "pos_scatter": (ops.pos_scatter_plain(c, B, coo),),
        "pos_scatter_pair": ops.pos_scatter_pair_plain(c, B, coo, 0.9),
        "pos_scatter_sq": (ops.pos_scatter_sq_plain(B, coo, 0.9),),
        "pos_seg_sum": (ops.pos_seg_sum_plain(c, coo),),
        "pos_seg_sum 1": (ops.pos_seg_sum_plain(c, coo, lanes=1),),
        "pos_seg_sum 8": (ops.pos_seg_sum_plain(c, coo, lanes=8),),
        "pos_hv_coo": (ops.pos_hv_coo_plain(phi, B, coo, 0.9),),
    }
    for name in got:
        for g, g2, r in zip(got[name], again[name], ref[name]):
            assert g.dtype == dtype and g.shape == r.shape, name
            assert torch.equal(_bits(g), _bits(g2)), name
            assert torch.equal(_bits(g), _bits(r)), name
    assert got["pos_seg_sum"][0][5] != 0  # the power row
    assert torch.equal(got["pos_scatter_pair"][0], got["pos_scatter"][0])
    assert torch.equal(got["pos_scatter_pair"][1], got["pos_scatter_sq"][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4, 8, 12, 32, 40, 256])
def test_pos_dot_matches_plain_bits(device, dtype, k):
    """``pos_dot`` bit-equal to its plain version (ghost ids clamped, n not
    a multiple of a group's entries), on repeat; one launch per call."""
    rng = np.random.default_rng(9)
    A = torch.as_tensor(rng.normal(size=(700, k))).to(device, dtype)
    B = torch.as_tensor(rng.normal(size=(300, k))).to(device, dtype)
    n = 5003
    u = rng.integers(0, 700, size=n).astype(np.int32)
    v = rng.integers(0, 300, size=n).astype(np.int32)
    u[-7:], v[-5:] = 700, 300
    u, v = torch.as_tensor(u, device=device), torch.as_tensor(v,
                                                              device=device)
    kernels.reset_launch_counts()
    got = kernels.pos_dot(A, u, B, v)
    assert kernels.launch_counts()["pos_dot"] == 1
    again = ops.pos_dot(A, u, B, v)
    ref = ops.pos_dot_plain(A, u, B, v)
    assert got.dtype == dtype and got.shape == (n,)
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(got), _bits(ref))
    with pytest.raises(TypeError):  # int32 ids only
        kernels.pos_dot(A, u.long(), B, v)


def test_coo_wrappers_reject_bad_inputs(device):
    """A list of a field's X, a table of the wrong height, coefficients of
    another dtype or too short for the list's stream positions, a list
    without weights for a weighted source are refused before a launch."""
    coo, c, wq, B = _coo_stream(device, torch.float32, 8, True, 128)
    with pytest.raises(ValueError, match="gathers from"):
        kernels.pos_scatter(c, B[:-1], coo)
    with pytest.raises(TypeError):
        kernels.pos_scatter(c.double(), B, coo)
    with pytest.raises(ValueError, match="stream positions"):
        kernels.pos_seg_sum(c[:100], coo)
    with pytest.raises(ValueError, match="not a list of the positive"):
        kernels.pos_scatter(c, B, coo._replace(pos=None))
    with pytest.raises(ValueError, match="no weights"):
        kernels.pos_scatter_pair(c, B, coo._replace(val=None), 0.9)


def _coo_solvers(device, cg_precond="none", blocked_bm=0):
    """The skewed FFM of ``_skewed_solvers`` with the head tier off: at
    ``blocked_bm=0`` both sides COO, at 8 rows per block its v side COO
    and its u side blocked; on the CPU and on the card from one set of
    tables."""
    from one_class_ffm_torch.data.synth import SynthSpec, build_padded
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.solver import torch_solver
    from one_class_ffm_torch.solver.params import HyperParams

    spec = SynthSpec(n_users=600, n_items=120, dims_u=(600, 30),
                     dims_v=(120, 20), avg_pos=5.0, seed=1, pop_skew=1.0)
    (du, dv), u, v, y = build_padded(spec, np.float32, row_multiple=8)
    hp = HyperParams(k=32, lam=0.05, omega=0.1, r=-1.0,
                     cg_precond=cg_precond)
    out = []
    for dev in ("cpu", device):
        meta, data = torch_solver.make_device_data(
            u, v, y, BlockLayout.make(du, dv, True), hp,
            dtype=torch.float32, blocked_bm=blocked_bm, head_chunk=0,
            device=dev)
        out.append(torch_solver.FFMSolver(meta, data))
    assert "coo_v" in out[1].data
    assert ("coo_u" in out[1].data) == (blocked_bm == 0)
    state = out[0].init(torch.Generator().manual_seed(0))
    params = {f: {n: t.to(device) for n, t in blk.items()}
              for f, blk in state["params"].items()}
    return out, (state, out[1].refresh_caches({"params": params}))


@pytest.mark.parametrize("cg_precond", ["none", "jacobi"])
@pytest.mark.parametrize("blocked_bm", [0, 8], ids=["coo", "mixed"])
def test_coo_solver_on_the_card_matches_the_cpu(device, cg_precond,
                                                 blocked_bm):
    """Both sides COO, or v COO and u blocked: the gradient, Hv and
    (Jacobi) diagonal of every block side on the card against the CPU's
    plain path; the COO kernels launch, no float atomics: one epoch run
    twice from one state gives the same bits, and the carry equals a fresh
    ``refresh_caches``."""
    (cpu, gpu), (cst, gst) = _coo_solvers(device, cg_precond, blocked_bm)
    sa_c, sb_c = cpu.sasb(cst)
    sa_g, sb_g = gpu.sasb(gst)
    rng = np.random.default_rng(2)
    for b in cpu.blocks:
        for first in (True, False):
            Gc, hvc, _, _, Dc = cpu.solve_inputs(cst, b, first, sa_c, sb_c)
            Gg, hvg, _, _, Dg = gpu.solve_inputs(gst, b, first, sa_g, sb_g)
            V = torch.as_tensor(rng.normal(size=tuple(Gc.shape)),
                                dtype=torch.float32)
            pairs = [(Gg, Gc), (hvg(V.to(device)), hvc(V))]
            if cg_precond == "jacobi":
                pairs.append((Dg, Dc))
            for got, ref in pairs:
                assert _max_rel(got.cpu(), ref) <= 1e-4, (b.f12, first)
    kernels.reset_launch_counts()
    g1, it1 = gpu.epoch_stats(gst)
    counts = kernels.launch_counts()
    assert counts["pos_hv_coo"] > 0 and counts["pos_seg_sum"] > 0
    assert counts["pos_dot"] > 0  # the COO gaps
    assert (counts["pos_scatter_pair"] > 0) == (cg_precond == "jacobi")
    assert (counts["pos_scatter"] > 0) == (cg_precond != "jacobi")
    g2, it2 = gpu.epoch_stats(gst)
    assert torch.equal(it1, it2)
    for key in ("yt_u", "yt_v", "a", "b"):
        assert torch.equal(_bits(g1[key]), _bits(g2[key])), key
    re = gpu.refresh_caches({"params": g1["params"]})
    for key in ("yt_u", "yt_v"):
        assert _max_rel(g1[key].cpu(), re[key].cpu()) <= 1e-4, key


def test_predict_on_the_card_matches_the_cpu(device, tmp_path):
    """The predictor on the card (B8 for every projection) against the
    same call on the CPU, on a small FFM model with self blocks and cold
    user rows: the same ids, scores within 1e-5 max-rel."""
    from one_class_ffm_torch import predict
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset
    from one_class_ffm_torch.train import TrainConfig, Trainer

    item, train, va = write_dataset(
        str(tmp_path), SynthSpec(n_users=300, n_items=60, avg_pos=10.0,
                                 seed=4))
    model = str(tmp_path / "model.txt")
    Trainer(TrainConfig(item_path=item, train_path=train, k=8, nr_pass=2,
                        model_path=model), device="cpu").run(
        log=lambda *_: None)
    users = tmp_path / "users.txt"
    with open(va) as fh:
        rows = [ln.split(None, 1)[1] for ln in fh if " " in ln.strip()]
    users.write_text("".join(rows) + "0:999999:1\n\n")
    lay, k, params = predict.load_any_model(model, None)
    popular = predict.read_data(train, has_label=True).popular
    out = {}
    for dev in ("cpu", device):
        kernels.reset_launch_counts()
        out[str(dev)] = predict.predict_topk_from_model(
            lay, k, params, item, str(users), 10, popular=popular,
            with_scores=True, chunk=128, device=dev)
        launched = kernels.launch_counts()["project"]
        assert (launched > 0) == (str(dev) != "cpu")
    (ids_c, s_c), (ids_g, s_g) = out["cpu"], out[str(device)]
    assert ids_g.shape == (len(rows) + 2, 10)
    assert np.abs(s_g - s_c).max() <= 1e-5 * np.abs(s_c).max()
    np.testing.assert_array_equal(ids_g, ids_c)


def test_serve_bench_at_tiny_sizes(device, monkeypatch, capsys):
    """serve_bench through its knobs: its JSON lines, and its ids equal to
    a stable sort on the CPU of the same bfloat16 scores (ties to the
    lowest id)."""
    import json

    from one_class_ffm_torch import serve_bench

    for key, val in dict(SB_USERS=1000, SB_ITEMS=700, SB_K=8, SB_CHUNK=256,
                         SB_TOPK=10, SB_REPS=2).items():
        monkeypatch.setenv(key, str(val))
    assert serve_bench.main([]) == 0
    lib, rec = [json.loads(ln) for ln in
                capsys.readouterr().out.strip().splitlines()[-2:]]
    assert rec["metric"] == "serving_users_per_sec" and rec["value"] > 0
    assert rec["catalog"] == 700 and len(rec["segments_users_per_sec"]) == 2
    assert "bfloat16" in rec["backend"] and rec["device"]
    assert lib["users_per_sec"] > 0
    P1, P2, Q1, Q2, bt = serve_bench.tables(1000, 700, 8, device,
                                            torch.bfloat16)
    ids = serve_bench.score_all(P1, P2, Q1, Q2, bt, 256, 10)
    assert ids.shape == (768, 10)
    z = (P1[:768] @ Q1.T + P2[:768] @ Q2.T + bt[None, :]).cpu()
    want = torch.sort(z.float(), dim=1, descending=True,
                      stable=True).indices[:, :10]
    srt = z.sort(dim=1).values
    assert (srt[:, 1:] == srt[:, :-1]).any()  # bfloat16 scores tie
    assert torch.equal(ids.cpu(), want)


# ---------------------------------------------------------------------------
# the CG recurrence (cg_ops.cu) and a solve's CUDA graphs
# ---------------------------------------------------------------------------


def _cg_equal(st_k, st_p) -> None:
    """The kernel's state against the plain version's: every vector and
    the scalars the loop reads, bit for bit."""
    for name in ("S", "R", "V", "Vs"):
        a, b = getattr(st_k, name), getattr(st_p, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    sk, sp = kernels.cg_scalars(st_k), ops.cg_scalars(st_p)
    for key in ("g2", "r2", "rz", "thr", "it", "done"):
        assert sk[key] == sp[key], (key, sk[key], sp[key])


def _cg_match(device, dtype, jacobi, rows, k, seed, steps=6, stop=3,
              converges=False):
    """cg_init and ``steps`` cg_steps on a (rows, k) system against the
    plain versions, bit for bit after each; the step numbered ``stop`` has
    a zero Hv (the den > 0 guard stops the solve; the steps after it write
    nothing).  ``converges``: a system small enough to meet the stop rule
    before that step (n = 1 does in one), whose count and flag are then
    the plain version's."""
    rng = np.random.default_rng(seed)

    def T(a, dt=dtype):
        return torch.as_tensor(a).to(device=device, dtype=dt).contiguous()

    G = T(rng.normal(size=(rows, k)))
    D = T(rng.uniform(0.5, 2.0, size=(rows, k)), torch.float32) \
        if jacobi else None
    st_k = kernels.cg_init(G, D, dtype, 1e-6, 20)
    st_p = ops.cg_init_plain(G, D, dtype, 1e-6, 20)
    torch.cuda.synchronize()
    _cg_equal(st_k, st_p)
    for step in range(steps):
        noise = T(rng.normal(size=(rows, k)), torch.float32)
        Hv = (torch.zeros_like(st_p.V) if step == stop
              else 2.0 * st_p.V + 0.1 * noise).to(dtype)
        kernels.cg_step(st_k, Hv)
        ops.cg_step_plain(st_p, Hv)
        torch.cuda.synchronize()
        _cg_equal(st_k, st_p)
        assert kernels.cg_read(st_k) == (st_p.sc["done"], st_p.sc["it"])
        if not converges:
            assert kernels.cg_read(st_k) == (step >= stop,
                                             min(step, stop) + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("rows,k", [(12, 3), (5000, 32), (300_000, 32),
                                    (5000 * 32 + 3, 1), (640_003, 1),
                                    (3_000_001, 1), (200_000, 32),
                                    (9_600_001, 1)])
def test_cg_kernels_match_plain(device, dtype, jacobi, rows, k):
    """cg_init and cg_step bit-equal to their plain versions (torch's own
    sums, the kernels' order) below 128 elements, with a tail, at several
    CTAs, with two virtual CTAs to all hardware CTAs but the last
    (3,000,001), at the card's most with V kept in shared memory (200,000 x
    32), and past what shared memory holds (9,600,001: grid-strided loads
    read again); a step whose Hv is zero
    stops the solve by the den > 0 guard, and the steps after it write
    nothing."""
    _cg_match(device, dtype, jacobi, rows, k, rows + k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jacobi", [False, True])
def test_cg_kernels_match_plain_at_every_small_size(device, dtype, jacobi):
    """Every n from 1 to 259 (single elements below 128, loads of 4 with
    each tail above), three steps, the second stopped by the guard."""
    for n in range(1, 260):
        _cg_match(device, dtype, jacobi, n, 1, n, steps=3, stop=1,
                  converges=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("n", [200, 32_000, 640_003, 6_400_000])
def test_cg_step_graph_replays_bit_equal(device, dtype, jacobi, n):
    """cg_step captured in a CUDA graph with an Hv of torch operations (one
    CTA, several, two virtual CTAs a hardware CTA) and replayed: the state
    after each replay is that of the same steps launched eagerly, bit for
    bit, up to the stop and past it (replays after the stop are no-ops);
    the replay's kernel is one launch."""
    rng = np.random.default_rng(n)
    G = torch.from_numpy(rng.normal(size=(n, 1))).to(device=device,
                                                       dtype=dtype)
    D = torch.from_numpy(rng.uniform(0.5, 2.0, size=(n, 1))).float().to(
        device) if jacobi else None
    noise = torch.from_numpy(rng.normal(size=(n, 1))).float().to(device)

    def hv(V):
        return (2.0 * V.float() + 0.1 * noise).to(dtype)

    cap = 5
    st_e = kernels.cg_init(G, D, dtype, 1e-30, cap)
    st_g = kernels.cg_init(G, D, dtype, 1e-30, cap)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    before = kernels.launch_counts()["cg_step"]
    with torch.cuda.stream(stream):
        graph.capture_begin()
        kernels.cg_step(st_g, hv(st_g.Vs))
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    assert kernels.launch_counts()["cg_step"] == before + 1
    for step in range(cap + 2):
        graph.replay()
        kernels.cg_step(st_e, hv(st_e.Vs))
        torch.cuda.synchronize()
        _cg_equal(st_g, st_e)
        assert kernels.cg_read(st_g) == (step + 1 >= cap,
                                         min(step + 1, cap))
    from torch.profiler import ProfilerActivity, profile

    Hv = hv(st_e.Vs)
    for _ in range(3):  # a trace without device events is the profiler's miss
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                kernels.cg_step(st_e, Hv)
            torch.cuda.synchronize()
        kern = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if kern:
            break
    assert len(kern) == 4 and all("cg_iter_kernel" in k for k in kern), kern


def _cta_sum(v):
    """(rows, threads) -> (rows,): Reduce.cuh's block_x_reduce of each row:
    halving through shared memory down to a warp, then the warp's shuffles
    down at offsets 16 .. 1 (halving too)."""
    w = v.shape[1]
    while w > 1:
        w //= 2
        v = v[:, :w] + v[:, w:2 * w]
    return v[:, 0]


def _strided(p, span: int):
    """Thread t's sum of rows t, t + span, ... of p in order, from 0."""
    n = p.shape[0]
    pad = torch.zeros((-(-n // span) * span - n, *p.shape[1:]),
                      dtype=p.dtype, device=p.device)
    p = torch.cat([p, pad])
    acc = torch.zeros((span, *p.shape[1:]), dtype=p.dtype, device=p.device)
    for j in range(p.shape[0] // span):
        acc = acc + p[j * span:(j + 1) * span]
    return acc


def reduce_model(p):
    """The order of torch's CUDA sum of a contiguous float32 tensor, which
    the recurrence kernels take (cg_ops.cu), at ``kernels.cg_config``'s
    launch for p's device: from n = 128 each thread adds its grid-strided
    loads of 4 in 4 accumulators, the first n % 4 threads the tail into the
    first, then ((a0 + a1) + a2) + a3; below it elements t and t +
    threads; then each CTA's ``_cta_sum``, and past one CTA, thread t of
    the last adds the partials t, t + threads, ... and halves again."""
    p = p.reshape(-1)
    n = p.numel()
    cfg = kernels.cg_config(n, p.device)
    span = cfg.threads * cfg.ctas
    if cfg.vec:
        nv = n // 4
        lanes = _strided(p[:nv * 4].view(nv, 4), span)
        if n % 4:
            lanes[:n % 4, 0] = lanes[:n % 4, 0] + p[nv * 4:]
    else:
        lanes = torch.zeros(span, 4, dtype=p.dtype, device=p.device)
        lanes[:, 0] = lanes[:, 0] + p[:span]
        lanes[:n - span, 1] = lanes[:n - span, 1] + p[span:]
    acc = ((lanes[:, 0] + lanes[:, 1]) + lanes[:, 2]) + lanes[:, 3]
    part = _cta_sum(acc.view(cfg.ctas, cfg.threads))
    if cfg.ctas == 1:
        return part[0]
    return _cta_sum(_strided(part, cfg.threads).view(1, cfg.threads))[0]


def plan_model(p, plan=None):
    """The same sum as the step kernel adds it on its hardware launch
    (``kernels.cg_plan``, cg_ops.cu cg_iter_kernel): hardware CTA b's thread
    t runs virtual thread t of virtual CTAs j * grid + b, j < per, one after
    the other, each over its loads k = 0, 1, ... in order (the first
    ``cache`` of them kept in shared memory, the rest read again: the same
    values), the tail in virtual CTA 0; the CTA halves one row of values per
    virtual CTA; each virtual CTA's sum goes to its slot of the partials;
    then every hardware CTA forms the grid's sum from all the partials.
    Returns the sum (every CTA's, which must agree) and the plan."""
    p = p.reshape(-1)
    n = p.numel()
    plan = plan or kernels.cg_plan(n, p.device)
    cfg = plan.cfg
    nt, C, H, P = cfg.threads, cfg.ctas, plan.grid, plan.per
    span = C * nt
    t = torch.arange(nt)
    vals = torch.zeros(H, P, nt, dtype=p.dtype)
    seen = torch.zeros(n, dtype=torch.int32)
    for j in range(P):
        c = j * H + torch.arange(H)
        valid = (c < C)[:, None]
        gt = c[:, None] * nt + t[None, :]
        lanes = torch.zeros(H, nt, 4, dtype=p.dtype)
        if cfg.vec:
            nv = n // 4
            p4 = p[:nv * 4].view(nv, 4)
            for k in range(plan.loads):
                idx = gt + k * span
                live = valid & (idx < nv)
                x = p4[idx.clamp(max=nv - 1)]
                lanes = torch.where(live[..., None], lanes + x, lanes)
                e = (idx[live] * 4)[:, None] + torch.arange(4)
                seen.index_add_(0, e.reshape(-1),
                                torch.ones(e.numel(), dtype=torch.int32))
            tail = n % 4
            if tail and j == 0:  # virtual CTA 0 is hardware CTA 0's first
                lanes[0, :tail, 0] = lanes[0, :tail, 0] + p[n - tail:]
                seen[n - tail:] += 1
        else:
            for lane in range(2):
                e = gt + lane * span
                live = valid & (e < n)
                x = p[e.clamp(max=n - 1)]
                lanes[..., lane] = torch.where(live, lanes[..., lane] + x,
                                               lanes[..., lane])
                seen.index_add_(0, e[live], torch.ones(
                    int(live.sum()), dtype=torch.int32))
        vals[:, j] = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) \
            + lanes[..., 3]
    assert torch.equal(seen, torch.ones_like(seen)), "an element twice"
    trees = _cta_sum(vals.view(H * P, nt)).view(H, P)
    if C == 1:
        return trees[0, 0], plan
    part = torch.zeros(C, dtype=p.dtype)
    for j in range(P):
        c = j * H + torch.arange(H)
        part[c[c < C]] = trees[c < C, j]
    sums = [_cta_sum(_strided(part, nt).view(1, nt))[0] for _ in range(H)]
    assert all(torch.equal(s.view(1), sums[0].view(1)) for s in sums)
    return sums[0], plan


def test_cg_sum_order_is_torch_sum(device):
    """The order the recurrence kernels add in (``reduce_model`` at
    ``kernels.cg_config``'s launch) gives the bits of torch's own sum on
    the card, at every launch shape: single elements, loads of 4 with a
    tail, one CTA, several, the most."""
    rng = np.random.default_rng(5)
    sizes = list(range(1, 260)) + [500 * 32, 1000 * 32, 5000 * 32 + 3,
                                   20000 * 32, 200000 * 32, 9_600_001]
    sizes += [int(x) for x in np.exp(rng.uniform(np.log(300), np.log(1e7),
                                                 40))]
    for n in sizes:
        a = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        x = (a.to(device) * b.to(device)).contiguous()
        assert torch.equal(_bits(reduce_model(x).view(1)),
                           _bits(x.sum().view(1))), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("rows", [3000, 200_000])
def test_cg_loop_is_the_eager_torch_loop(device, dtype, jacobi, rows):
    """A solve on the recurrence kernels gives the S and the count of the
    eager torch loop they replaced (mesh_accuracy._torch_cg_loop: torch's
    operations and sums), bit for bit, on one CTA and on the card's most
    (200,000 x 32: two virtual CTAs a hardware CTA)."""
    import os
    import sys
    import types

    from one_class_ffm_torch.solver.params import HyperParams

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import mesh_accuracy
    finally:
        sys.path.remove(root)
    rng = np.random.default_rng(7)
    k = 32
    A = torch.from_numpy(rng.normal(size=(k, k)) / k).float().to(device)
    A = A @ A.T + 0.05 * torch.eye(k, device=device)
    w = torch.from_numpy(rng.uniform(0.5, 4.0, size=(rows, 1))).float().to(
        device)

    def hv(V):
        return (w * (V.float() @ A)).to(dtype)

    G = torch.from_numpy(rng.normal(size=(rows, k))).float().to(device)
    D = (w * torch.diagonal(A)[None, :]).contiguous() if jacobi else None
    hp = HyperParams(cg_eps=1e-8, cg_max_iter=12)
    ns = types.SimpleNamespace(meta=types.SimpleNamespace(hp=hp,
                                                          dtype=dtype))
    S_t, it_t = mesh_accuracy._torch_cg_loop(ns, hv, G, D)
    st = kernels.cg_init(G, D, dtype, hp.cg_eps, hp.cg_max_iter)
    while not kernels.cg_read(st)[0]:
        kernels.cg_step(st, hv(st.Vs))
    assert kernels.cg_read(st)[1] == it_t
    assert torch.equal(_bits(st.S), _bits(S_t))


def _small_trainer(device, case: str):
    """A small chip_smoke trainer on the card: FFM with self blocks
    (identity and fused fields), under Jacobi, at bfloat16, FM above a
    lowered fused cap, both sides COO, and the head tier on both sides."""
    import contextlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    kw = dict(k=8)
    fm = case == "fm"
    data = cs.build_data(1024, 256, 5.0, seed=3, dims_u=(1024, 40),
                         dims_v=(256, 24), self_side=True, fm=fm,
                         power=2 if case == "skew" else 0)
    if case == "jacobi":
        kw["cg_precond"] = "jacobi"
        data = cs._without_repeated_ids(data)
    elif case == "bf16":
        kw["dtype"] = "bfloat16"
    elif case == "coo":
        kw["blocked_bm"] = 0
    elif case == "skew":
        kw.update(blocked_bm=32, head_chunk=16)
    with cs.fused_cap(8) if fm else contextlib.nullcontext():
        tr = cs.make_trainer(data, device, **kw)
    if case == "skew":
        assert tr.solver.hd_u and tr.solver.hd_v
    return tr


def _state_bits(a, b) -> bool:
    same = True
    for key, t in a.items():
        if isinstance(t, torch.Tensor):
            same = same and torch.equal(_bits(t), _bits(b[key]))
        elif key in ("P", "Q"):
            same = same and all(torch.equal(_bits(x), _bits(b[key][f]))
                                for f, x in t.items())
        elif key == "params":
            same = same and all(
                torch.equal(_bits(x), _bits(b[key][f][n]))
                for f, blk in t.items() for n, x in blk.items())
    return same


@pytest.mark.parametrize("case", ["ffm", "jacobi", "bf16", "fm", "coo",
                                  "skew"])
@pytest.mark.parametrize("group", [1, 3, 20])
def test_graph_replays_equal_the_eager_loop(device, case, group):
    """Two epochs from one state through the CUDA graph path (captured in
    the first, replayed in both) against the eager loop with a host test
    per iteration: the same tables, caches, residuals and CG counts, bit
    for bit; every launch of a replay counted, the recurrence kernel's
    among them; the masked iterations those of the groups."""
    tr = _small_trainer(device, case)
    solver = tr.solver
    state = tr.init_state()
    solver.cg_host_loop = True
    eager1, it1 = solver.epoch_stats(state)
    eager2, it2 = solver.epoch_stats(eager1)
    solver.cg_host_loop, solver.cg_group = False, group
    assert solver._graph_path()
    kernels.reset_launch_counts()
    before = dict(solver.cg_counts)
    graph1, jt1 = solver.epoch_stats(state)
    graph2, jt2 = solver.epoch_stats(graph1)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    assert torch.equal(jt1, it1) and torch.equal(jt2, it2)
    assert _state_bits(graph1, eager1) and _state_bits(graph2, eager2)
    its = torch.cat([it1, it2])
    groups = ((its + group - 1) // group).clamp(min=1)
    assert solver.cg_counts["replays"] - before["replays"] == int(
        groups.sum())
    assert solver.cg_counts["masked"] - before["masked"] == int(
        (groups * group - its).sum())
    assert launches["cg_step"] == int(groups.sum()) * group
    assert launches["cg_init"] == its.numel()
    assert len(solver._graphs.graphs) == 2 * len(solver.blocks)


def test_graph_refuses_buffers_it_was_not_captured_on(device):
    """A closure key whose input changes shape would read another buffer
    than its graph does: the solve raises instead of replaying on stale
    data."""
    from one_class_ffm_torch.solver.torch_solver import FFMSolver

    solver = _small_trainer(device, "ffm").solver

    def make(x):
        return lambda V: x["scale"] * V

    def hv(rows):
        return FFMSolver._hv_closure(("moved",), dict(
            scale=torch.full((rows, 8), 2.0, device=device)), make)

    G = torch.randn(64, 8, device=device)
    S, it = solver._cg_loop(hv(64), G)
    assert it == 1 and torch.allclose(S, -G / 2.0)
    with pytest.raises(RuntimeError, match="captured on"):
        solver._cg_loop(hv(32), G[:32])


def test_graph_path_raises_instead_of_falling_back(device):
    """A closure that cannot be captured (it reads the card from the host)
    raises on the graph path; the eager loop runs it."""
    from one_class_ffm_torch.solver.torch_solver import FFMSolver

    tr = _small_trainer(device, "ffm")
    solver = tr.solver
    G = torch.randn(64, 8, device=device)

    def make(x):
        def hv(V):
            if float(V.abs().sum()) < 0:  # a host read: refused in a capture
                return -V
            return x["scale"] * V
        return hv

    hv = FFMSolver._hv_closure(("host-read",), dict(
        scale=torch.full((64, 8), 2.0, device=device)), make)
    with pytest.raises(RuntimeError):
        solver._cg_loop(hv, G)
    solver.cg_host_loop = True
    S, it = solver._cg_loop(hv, G)
    assert it == 1 and torch.allclose(S, -G / 2.0)
