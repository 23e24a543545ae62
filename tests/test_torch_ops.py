"""The port's plain ops against the JAX package's ops and kernels.

Inputs are made with numpy from a seed and go through both sides.  The JAX
k-major (kt) and row-major Pallas kernels run in interpret mode at float64,
as tests/test_ops.py runs them; the bound is rtol 1e-9 (float64
reassociation only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops
from one_class_ffm_torch.ops.layout import (
    FeatureMajor,
    feature_major,
    make_blocked_layout,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11


@pytest.fixture(params=["sorted", "unsorted"])
def fx(request):
    """A random blocked stream: u-sorted (the u side) or unsorted (the v
    side, stable-sorted by the layout)."""
    rng = np.random.default_rng(5)
    num, n_other, nnz, k, BM = 32, 20, 150, 5, 8
    seg = rng.integers(0, num, size=nnz).astype(np.int32)
    if request.param == "sorted":
        seg = np.sort(seg)
    take_ids = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(seg, take_ids, num, BM, max_pad_ratio=50.0)
    B = rng.normal(size=(n_other, k))
    rows = B[blk["take"]]
    return dict(rng=rng, num=num, k=k, BM=BM, B=B, blk=blk, rows=rows,
                own=blk["own"], rows_t=np.transpose(rows, (0, 2, 1)))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pos_hv_blocked_matches_jax(fx):
    rng, num, k, BM, own = fx["rng"], fx["num"], fx["k"], fx["BM"], fx["own"]
    phi = rng.normal(size=(num, k))
    w_blk = rng.random(own.shape) * (own < BM)
    dmat = rng.normal(size=(k, k))
    scale = 0.61
    got = tops.pos_hv_blocked(T(phi), T(fx["rows"]), T(own), T(w_blk),
                              T(dmat), num, BM, w_scale=scale).numpy()
    kt = jops.pos_hv_kt_pallas(
        jnp.asarray(phi), jnp.asarray(fx["rows_t"]), jnp.asarray(own),
        jnp.asarray(w_blk), jnp.asarray(dmat), num, BM, w_scale=scale,
        interpret=True)
    row_major = jops.pos_hv_blocked_pallas(
        jnp.asarray(phi), jnp.asarray(fx["rows"]), jnp.asarray(own),
        jnp.asarray(w_blk), jnp.asarray(dmat), num, BM, w_scale=scale,
        interpret=True)
    xla = jops.pos_hv_blocked(
        jnp.asarray(phi), None, None, None, None, jnp.asarray(own), num, BM,
        rows=jnp.asarray(fx["rows"]), w_blk=jnp.asarray(w_blk),
        w_scale=scale, dense_mat=jnp.asarray(dmat))
    for ref in (kt, row_major, xla):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_pos_scatter_blocked_matches_jax(fx):
    rng, num, BM, own = fx["rng"], fx["num"], fx["BM"], fx["own"]
    c_blk = rng.normal(size=own.shape)
    got = tops.pos_scatter_blocked(T(c_blk), T(fx["rows"]), T(own), num,
                                   BM).numpy()
    kt = jops.pos_scatter_kt_pallas(
        jnp.asarray(c_blk), jnp.asarray(fx["rows_t"]), jnp.asarray(own), num,
        BM, interpret=True)
    xla = jops.pos_scatter_blocked(
        None, None, jnp.asarray(fx["blk"]["take"]), None, jnp.asarray(own),
        num, BM, rows=jnp.asarray(fx["rows"]), coeff_blk=jnp.asarray(c_blk))
    for ref in (kt, xla):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_pos_gap_blocked_matches_jax(fx):
    rng, num, k, BM, own = fx["rng"], fx["num"], fx["k"], fx["BM"], fx["own"]
    dP = rng.normal(size=(num, k))
    got = tops.pos_gap_blocked(T(dP), T(fx["rows"]), T(own), BM).numpy()
    kt = jops.pos_gap_kt_pallas(jnp.asarray(dP), jnp.asarray(fx["rows_t"]),
                                jnp.asarray(own), BM, interpret=True)
    xla = jops.pos_gap_blocked(jnp.asarray(dP), jnp.asarray(fx["rows"]),
                               jnp.asarray(own), None, BM)
    for ref in (kt, xla):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert np.all(got.reshape(own.shape)[own == BM] == 0.0)  # pads exactly 0


def test_plain_tensor_ops_match_jax(fx):
    rng, num, k, B = fx["rng"], fx["num"], fx["k"], fx["B"]
    take = fx["blk"]["take"]
    np.testing.assert_array_equal(
        tops.gather_blocked_rows(T(B), T(take)).numpy(),
        np.asarray(jops.gather_blocked_rows(jnp.asarray(B),
                                            jnp.asarray(take))))
    idx = rng.integers(0, 9, size=(num, 3)).astype(np.int32)
    val = rng.random((num, 3))
    W = rng.normal(size=(9, k))
    np.testing.assert_allclose(
        tops.project(T(idx), T(val), T(W)).numpy(),
        np.asarray(jops.project(jnp.asarray(idx), jnp.asarray(val),
                                jnp.asarray(W))), rtol=RTOL, atol=ATOL)
    A = rng.normal(size=(num, k))
    u = rng.integers(0, num, size=40).astype(np.int32)
    v = rng.integers(0, B.shape[0], size=40).astype(np.int32)
    ref = np.asarray(jops.pos_dot(jnp.asarray(A), jnp.asarray(u),
                                  jnp.asarray(B), jnp.asarray(v)))
    np.testing.assert_allclose(tops.pos_dot(T(A), T(u), T(B), T(v)).numpy(),
                               ref, rtol=RTOL, atol=ATOL)
    # chunked form, and ghost ids at the row count clamp as XLA's do
    u[-3:] = num
    ref = np.asarray(jops.pos_dot(jnp.asarray(A), jnp.asarray(u),
                                  jnp.asarray(B), jnp.asarray(v)))
    np.testing.assert_allclose(
        tops.pos_dot(T(A), T(u), T(B), T(v), max_chunk=7).numpy(), ref,
        rtol=RTOL, atol=ATOL)


def test_cpu_tensors_never_launch(fx):
    """CPU tensors take the plain versions and bump no launch count."""
    rng, num, k, BM, own = fx["rng"], fx["num"], fx["k"], fx["BM"], fx["own"]
    kernels.reset_launch_counts()
    rows, own_t = T(fx["rows"]), T(own)
    tops.pos_hv_blocked(T(rng.normal(size=(num, k))), rows, own_t,
                        T(rng.random(own.shape)), T(np.eye(k)), num, BM)
    tops.pos_scatter_blocked(T(rng.normal(size=own.shape)), rows, own_t, num,
                             BM)
    tops.pos_gap_blocked(T(rng.normal(size=(num, k))), rows, own_t, BM)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


@pytest.mark.parametrize("op", ["hv", "scatter", "gap"])
def test_kernel_wrappers_reject_cpu_tensors(fx, op):
    """The launch wrappers take CUDA tensors only: a CPU tensor raises
    before any build is attempted (no fallback inside a wrapper)."""
    num, k, BM, own = fx["num"], fx["k"], fx["BM"], T(fx["own"])
    rows = T(fx["rows"]).float()
    own32 = own.int()
    with pytest.raises(ValueError, match="CUDA"):
        if op == "hv":
            kernels.pos_hv_blocked(torch.zeros(num, k), rows, own32,
                                   torch.zeros(own.shape), torch.eye(k), num,
                                   BM)
        elif op == "scatter":
            kernels.pos_scatter_blocked(torch.zeros(own.shape), rows, own32,
                                        num, BM)
        else:
            kernels.pos_gap_blocked(torch.zeros(num, k), rows, own32, BM)


def test_dispatch_rejects_other_devices(fx):
    rows = torch.empty(fx["rows"].shape, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.pos_gap_blocked(rows, rows, rows, fx["BM"])


def test_library_name_tracks_sources_and_flags(monkeypatch):
    """The build is keyed by a hash of the sources and the nvcc flags."""
    first = kernels.library_path()
    assert first.parent == kernels.BUILD_DIR
    assert first == kernels.library_path()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-g",))
    assert kernels.library_path() != first


def test_missing_nvcc_raises(monkeypatch):
    """No compiler: building raises (nothing falls back to the plain
    versions)."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


# ---------------------------------------------------------------------------
# fused table-space passes and the self-block tensor ops
# ---------------------------------------------------------------------------

TBL_RTOL = 1e-5  # float32: the port and the TPU kernels sum in other orders


def _field(rng, num, d, p=3, n_pad_rows=3):
    """A padded feature field (num, p) at float32: duplicate ids within some
    rows, pad slots (idx 0, val 0) and pad rows at the end."""
    idx = rng.integers(0, d, size=(num, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(num, p)).astype(np.float32)
    idx[::5, 2] = idx[::5, 1]
    pad = rng.random((num, p)) < 0.25
    pad[:, 0] = False
    idx[pad], val[pad] = 0, 0.0
    idx[num - n_pad_rows:], val[num - n_pad_rows:] = 0, 0.0
    return idx, val


def _torch_xt(idx, val, d):
    fm = feature_major(idx, val, d)
    return FeatureMajor(row=T(fm.row), val=T(fm.val), chunk_ptr=T(fm.chunk_ptr),
                        feat_ptr=T(fm.feat_ptr), n_rows=fm.n_rows)


def _max_rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("op", ["pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl",
                                "grad_self_tbl"])
def test_table_ops_match_both_jax_twins(fx, op):
    """Each fused table pass (the port's plain version, as the CPU runs it)
    against the row-major Pallas kernel and its k-major twin, both in
    interpret mode, on one float32 field with duplicate ids and pads."""
    rng, num, k, BM, own = fx["rng"], fx["num"], fx["k"], fx["BM"], fx["own"]
    d = 13
    idx, val = _field(rng, num, d)
    f32 = np.float32
    rows, rows_t = fx["rows"].astype(f32), fx["rows_t"].astype(f32)
    V = rng.normal(size=(d, k)).astype(f32)
    Q1 = rng.normal(size=(num, k)).astype(f32)
    w_blk = (rng.random(own.shape) * (own < BM)).astype(f32)
    c_blk = (rng.normal(size=own.shape) * (own < BM)).astype(f32)
    dmat = rng.normal(size=(k, k)).astype(f32)
    dense = rng.normal(size=(num, k)).astype(f32)
    dd = rng.uniform(1.0, 5.0, size=num).astype(f32)
    zdense = rng.normal(size=num).astype(f32)
    xt = _torch_xt(idx, val, d)
    J = jnp.asarray
    it, vt = J(idx.T), J(val.T)
    scale = 0.9
    if op == "pos_hv_tbl":
        got = tops.pos_hv_tbl(T(V), T(idx), T(val), xt, T(rows), T(own),
                              T(w_blk), T(dmat), BM, scale)
        refs = (jops.pos_hv_tbl_pallas(J(V), it, vt, J(rows), J(own),
                                       J(w_blk), J(dmat), BM, w_scale=scale,
                                       interpret=True),
                jops.pos_hv_tbl_kt_pallas(J(V), it, vt, J(rows_t), J(own),
                                          J(w_blk), J(dmat), BM,
                                          w_scale=scale, interpret=True))
    elif op == "grad_cross_tbl":
        got = tops.grad_cross_tbl(xt, T(rows), T(own), T(c_blk), T(dense),
                                  BM)
        refs = (jops.grad_cross_tbl_pallas(d, it, vt, J(rows), J(own),
                                           J(c_blk), J(dense), BM,
                                           interpret=True),
                jops.grad_cross_tbl_kt_pallas(d, it, vt, J(rows_t), J(own),
                                              J(c_blk), J(dense), BM,
                                              interpret=True))
    elif op == "hv_self_tbl":
        got = tops.hv_self_tbl(T(V), T(idx), T(val), xt, T(Q1), T(dd))
        refs = (jops.hv_self_tbl_pallas(J(V), it, vt, J(Q1), J(dd[:, None]),
                                        BM, interpret=True),
                jops.hv_self_tbl_kt_pallas(J(V), it, vt, J(Q1),
                                           J(dd[None, :]), BM,
                                           interpret=True))
    else:
        got = tops.grad_self_tbl(xt, T(Q1), T(zdense), T(own), T(c_blk), BM)
        refs = (jops.grad_self_tbl_pallas(d, it, vt, J(Q1),
                                          J(zdense[:, None]), J(own),
                                          J(c_blk), BM, interpret=True),
                jops.grad_self_tbl_kt_pallas(d, it, vt, J(Q1),
                                             J(zdense[None, :]), J(own),
                                             J(c_blk), BM, interpret=True))
    # the table-space result stays at the float32 floor, unrounded
    assert got.dtype == torch.float32 and got.shape == (d, k)
    for ref in refs:
        assert np.asarray(ref).shape == (d, k)
        assert _max_rel(got.numpy(), ref) <= TBL_RTOL


def test_seg_sum_and_expand_rows_match_jax(fx):
    rng, num, BM, own = fx["rng"], fx["num"], fx["BM"], fx["own"]
    c_blk = rng.normal(size=own.shape) * (own < BM)
    got = tops.seg_sum_blocked(T(c_blk), T(own), num, BM).numpy()
    ref = jops.seg_sum_blocked(jnp.asarray(c_blk), jnp.asarray(own), num, BM)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    vec = rng.normal(size=num)
    got = tops.expand_rows_blocked(T(vec), T(own), BM).numpy()
    ref = jops.expand_rows_blocked(jnp.asarray(vec), jnp.asarray(own), BM)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert np.all(got.reshape(own.shape)[own == BM] == 0.0)


def test_table_ops_on_cpu_never_launch(fx):
    rng, num, k, BM, own = fx["rng"], fx["num"], fx["k"], fx["BM"], fx["own"]
    idx, val = _field(rng, num, 7)
    xt = _torch_xt(idx, val.astype(np.float64), 7)
    Q1, V = T(rng.normal(size=(num, k))), T(rng.normal(size=(7, k)))
    c = T(rng.normal(size=own.shape))
    kernels.reset_launch_counts()
    tops.pos_hv_tbl(V, T(idx), T(val.astype(np.float64)), xt, T(fx["rows"]),
                    T(own), T(rng.random(own.shape)), T(np.eye(k)), BM)
    tops.grad_cross_tbl(xt, T(fx["rows"]), T(own), c, Q1, BM)
    tops.hv_self_tbl(V, T(idx), T(val.astype(np.float64)), xt, Q1,
                     T(rng.random(num)))
    tops.grad_self_tbl(xt, Q1, T(rng.random(num)), T(own), c, BM)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


@pytest.mark.parametrize("op", ["pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl",
                                "grad_self_tbl"])
def test_table_wrappers_reject_cpu_tensors(fx, op):
    num, k, BM = fx["num"], fx["k"], fx["BM"]
    own = T(fx["own"]).int()
    rows = T(fx["rows"]).float()
    idx, val = _field(fx["rng"], num, 5)
    xt = _torch_xt(idx, val, 5)
    with pytest.raises(ValueError, match="CUDA"):
        if op == "pos_hv_tbl":
            kernels.pos_hv_tbl(torch.zeros(5, k), T(idx), T(val), xt, rows,
                               own, torch.zeros(own.shape), torch.eye(k), BM)
        elif op == "grad_cross_tbl":
            kernels.grad_cross_tbl(xt, rows, own, torch.zeros(own.shape),
                                   torch.zeros(num, k), BM)
        elif op == "hv_self_tbl":
            kernels.hv_self_tbl(torch.zeros(5, k), T(idx), T(val), xt,
                                torch.zeros(num, k), torch.zeros(num))
        else:
            kernels.grad_self_tbl(xt, torch.zeros(num, k), torch.zeros(num),
                                  own, torch.zeros(own.shape), BM)
