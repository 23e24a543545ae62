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
from one_class_ffm_torch.ops.layout import make_blocked_layout

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
