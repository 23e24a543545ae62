"""Wide feature fields: the projection B8 (``project``) and the general
scatter (``scatter``) against the JAX package's ops, and the solver and the
evaluator on non-identity fields above the fused-table cap against the fp64
oracle, the JAX solver and the JAX evaluator.

To keep the problems small the cap is lowered to ``CAP`` on both sides: the
port's ``torch_solver.FUSED_TBL_D`` is monkeypatched and the JAX package
reads ``OCFFM_FUSED_TBL_D``.  A field wider than the cap takes the general
path (B8, the blocked passes, the X^T stage); a narrower one keeps the fused
table passes.  The JAX solver runs its k-major kernels in interpret mode
with the per-solve pregather forced, as tests/test_torch_solver.py runs it;
its wide fields take XLA's ``project`` and ``scatter``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_to_padded, make_problem
from one_class_ffm_tpu.data.dataset import PaddedFields
from one_class_ffm_tpu.evalx import jax_eval
from one_class_ffm_tpu.models.blocks import BlockLayout
from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_tpu.solver import oracle
from one_class_ffm_torch.evalx import torch_eval
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops
from one_class_ffm_torch.ops.layout import FeatureMajor, feature_major
from one_class_ffm_torch.solver import torch_solver
from test_torch_solver import build_jax, build_port, mf_problem

torch.set_num_threads(1)

CAP = 8  # the lowered fused-table cap


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _field(rng, rows, d, p=3, n_pad_rows=4, dtype=np.float64):
    """A padded feature field (rows, p): duplicate ids within some rows,
    pad slots (idx 0, val 0), pad rows at the end, and feature 3 in every
    real row (a heavy feature whose run spans several chunks)."""
    idx = rng.integers(0, d, size=(rows, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(rows, p)).astype(dtype)
    idx[:, 0] = 3
    idx[::5, 2] = idx[::5, 1]
    pad = rng.random((rows, p)) < 0.25
    pad[:, 0] = False
    idx[pad], val[pad] = 0, 0.0
    idx[rows - n_pad_rows:], val[rows - n_pad_rows:] = 0, 0.0
    return idx, val


def _torch_xt(idx, val, d):
    fm = feature_major(idx, val, d)
    return FeatureMajor(row=T(fm.row), val=T(fm.val), chunk_ptr=T(fm.chunk_ptr),
                        feat_ptr=T(fm.feat_ptr), n_rows=fm.n_rows)


# ---------------------------------------------------------------------------
# B8 and the general scatter against the JAX package's ops
# ---------------------------------------------------------------------------

# float32: XLA may contract a product and the running sum into one fused
# multiply-add, which rounds once where the port rounds twice
PROJECT_RTOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_project_plain_matches_project_xla(dtype):
    """Above the old cap (D > 4096), with duplicate ids and pad rows."""
    rng = np.random.default_rng(0)
    rows, d, k = 96, 5000, 8
    idx, val = _field(rng, rows, d, dtype=dtype)
    W = rng.random((d, k)).astype(dtype)
    got = tops.project_plain(T(idx), T(val), T(W))
    ref = np.asarray(jops.project_xla(jnp.asarray(idx), jnp.asarray(val),
                                      jnp.asarray(W)))
    assert got.dtype == T(W).dtype and got.shape == (rows, k)
    np.testing.assert_allclose(got.numpy(), ref, rtol=PROJECT_RTOL[dtype])
    assert np.all(got.numpy()[rows - 4:] == 0.0)  # pad rows project to 0


def test_project_plain_matches_project_pallas_interpret():
    """The TPU kernel in interpret mode (as tests/test_ops.py runs it):
    rows a multiple of its 256-row block, a small table.  rtol 1e-6 at
    float32: the one-hot matmul adds a row's slots in another order."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(1)
    rows, d, k = jops._BM * 2, 40, 8
    idx, val = _field(rng, rows, d, dtype=np.float32)
    W = rng.random((d, k)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jops.project_pallas(jnp.asarray(idx), jnp.asarray(val),
                                  jnp.asarray(W))
    got = tops.project(T(idx), T(val), T(W))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_project_plain_drops_ids_outside_the_table():
    """An id outside [0, D) adds nothing, as the TPU kernel's one-hot X
    drops it (project_xla would clamp it to the last row)."""
    rng = np.random.default_rng(2)
    idx, val = _field(rng, 16, 9)
    W = rng.random((9, 4))
    ghost = idx.copy()
    ghost[::3, 1] = 9
    ghost[1::3, 2] = -1
    cut = val.copy()
    cut[ghost != idx] = 0.0
    np.testing.assert_array_equal(
        tops.project_plain(T(ghost), T(val), T(W)).numpy(),
        tops.project_plain(T(idx), T(cut), T(W)).numpy())


def test_table_passes_project_with_b8_plain():
    """The fused table passes' phi = X V is ``project_plain`` itself, so a
    field's phi is the same bits in the table passes and in dP."""
    rng = np.random.default_rng(3)
    num, d, k = 24, 7, 4
    idx, val = _field(rng, num, d)
    xt = _torch_xt(idx, val, d)
    V, Q1 = T(rng.normal(size=(d, k))), T(rng.normal(size=(num, k)))
    dd = T(rng.random(num) + 1.0)
    phi = tops.project_plain(T(idx), T(val), V)
    ref = tops.scatter_plain(
        xt, (dd * (Q1 * phi).sum(dim=1))[:, None] * Q1)
    got = tops.hv_self_tbl_plain(V, T(idx), T(val), xt, Q1, dd)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scatter_matches_scatter_xla(dtype):
    """X^T Z at D above the old cap, with duplicate ids, pad slots, pad
    rows (val == 0, left out of the list) and a feature split over chunks;
    the result comes back at storage dtype.  float32: rtol 1e-5, the two
    add a feature's entries in other orders."""
    rng = np.random.default_rng(4)
    rows, d, k = 300, 4500, 8
    idx, val = _field(rng, rows, d, dtype=dtype)
    xt = _torch_xt(idx, val, d)
    assert int(np.diff(xt.feat_ptr.numpy())[3]) > 1  # the heavy feature
    Z = rng.random((rows, k)).astype(dtype)
    kernels.reset_launch_counts()
    got = tops.scatter(xt, T(Z))
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain version
    ref = np.asarray(jops.scatter_xla(jnp.asarray(idx), jnp.asarray(val),
                                      jnp.asarray(Z), d))
    assert got.dtype == T(Z).dtype and got.shape == (d, k)
    np.testing.assert_allclose(got.numpy(), ref,
                               rtol=1e-5 if dtype == np.float32 else 1e-12,
                               atol=1e-6 if dtype == np.float32 else 1e-14)


@pytest.mark.parametrize("op", ["project", "scatter"])
def test_wrappers_reject_cpu_tensors(op):
    rng = np.random.default_rng(5)
    idx, val = _field(rng, 12, 6, dtype=np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        if op == "project":
            kernels.project(T(idx), T(val), torch.zeros(6, 4))
        else:
            kernels.scatter(_torch_xt(idx, val, 6), torch.zeros(12, 4))


# ---------------------------------------------------------------------------
# the solver on wide fields
# ---------------------------------------------------------------------------

WIDE_CASES = ("fm_self", "fm_ns", "ffm_mixed")


@pytest.fixture
def low_cap(monkeypatch):
    monkeypatch.setattr(torch_solver, "FUSED_TBL_D", CAP)
    monkeypatch.setenv("OCFFM_FUSED_TBL_D", str(CAP))


def wide_problem(case, seed=1, m=13, n=9, k=3):
    """fm_self / fm_ns: one mixed field per side (the id columns and the
    features in one field, as the FM encoding flattens them), D = m + 6 and
    n + 5, with or without self blocks; ffm_mixed: user fields (identity,
    wide D = 12, small D = 5), item fields (identity, wide D = 11), self
    blocks."""
    rng = np.random.default_rng(seed)
    kw = dict(m=m, n=n, k=k, cg_precond="none")
    if case.startswith("fm"):
        prob, params = make_problem(rng, Du=(m + 6,), Dv=(n + 5,), max_nnz=2,
                                    self_side=case == "fm_self", **kw)
        for Xs, fr, rows in ((prob.Xu, prob.freq_u, m),
                             (prob.Xv, prob.freq_v, n)):
            Xs[0][:, :rows] = np.eye(rows)
            fr[0][:] = Xs[0].astype(bool).sum(axis=0)
        return prob, params
    prob, params = make_problem(rng, Du=(m, 12, 5), Dv=(n, 11), max_nnz=3,
                                self_side=True, **kw)
    for Xs, fr in ((prob.Xu, prob.freq_u), (prob.Xv, prob.freq_v)):
        Xs[0][:] = np.eye(Xs[0].shape[0])
        fr[0][:] = 1.0
    return prob, params


def _sides(solver, prob):
    """{(f12, first): 'ident' | 'fused' | 'wide'} for every block side."""
    out = {}
    for b in prob.layout.all_blocks():
        for first in (True, False):
            xf = solver._x(b, first)[2]
            out[(b.f12, first)] = ("ident" if xf is None else
                                   "fused" if solver._fused(b, first)
                                   else "wide")
    return out


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_two_epochs_match_oracle(case, low_cap):
    prob, params = wide_problem(case)
    solver, state = build_port(prob, params)
    kinds = set(_sides(solver, prob).values())
    assert "wide" in kinds
    assert kinds == ({"wide"} if case.startswith("fm")
                     else {"ident", "fused", "wide"})
    kernels.reset_launch_counts()
    ref = params
    for _ in range(2):
        ref = oracle.oracle_epoch(prob, ref)
        state = solver.epoch(state)
    for f12 in ref["W"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                state["params"][f12][name].numpy(), ref[name][f12],
                rtol=1e-6, atol=1e-9, err_msg=f"{case} {name} {f12}")
    np.testing.assert_allclose(float(solver.objective(state)),
                               oracle.objective(prob, ref), rtol=1e-8)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_gradient_and_hv_match_oracle(case, low_cap):
    """Every block side: the general path's gradient (lam reg T +
    scatter(...)) and Hv (B8, the blocked pass or the self term, the X^T
    stage)."""
    prob, params = wide_problem(case)
    solver, state = build_port(prob, params)
    sa, sb = solver.sasb(state)
    rng = np.random.default_rng(3)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G, hv, _ = solver.grad_and_hv(state, b, first, sa, sb)
            G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8,
                                       atol=1e-10, err_msg=f"{b.f12}")
            V = rng.normal(size=G_ref.shape)
            np.testing.assert_allclose(hv(torch.from_numpy(V)).numpy(),
                                       hv_ref(V), rtol=1e-8, atol=1e-10,
                                       err_msg=f"{b.f12}")


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_two_epochs_match_jax(case, low_cap, monkeypatch):
    """Against the JAX solver, whose wide fields take project / scatter
    (XLA) around its k-major kernels: equal per-solve CG iteration counts
    and matching tables (rtol 1e-9: float64, sums in other orders)."""
    prob, params = wide_problem(case, seed=4)
    tsolver, tst = build_port(prob, params)
    jsolver, jst = build_jax(prob, params, monkeypatch)
    for (f12, first), kind in _sides(tsolver, prob).items():
        b = next(x for x in prob.layout.all_blocks() if x.f12 == f12)
        dim = b.d1 if first else b.d2
        fused = jsolver._fused_tbl_side(b, first, dim) is not None
        assert fused == (kind == "fused"), (f12, first, kind)
    for _ in range(2):
        tst, t_it = tsolver.epoch_stats(tst)
        jst, j_it = jsolver.epoch_stats(jst)
        np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
        assert t_it.sum() > 0
    for f12 in jst["params"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                tst["params"][f12][name].numpy(),
                np.asarray(jst["params"][f12][name]), rtol=1e-9, atol=1e-12,
                err_msg=f"{name} {f12}")
    for key in ("yt_u", "yt_v", "a", "b"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(float(tsolver.objective(tst)),
                               float(jsolver.objective(jst)), rtol=1e-10)


def test_wide_field_above_the_default_cap_trains():
    """An item field of FUSED_TBL_D + 1 features (no longer identity) at
    the shipped cap: it builds its feature-major list, takes the general
    path and an epoch lowers the objective."""
    prob, params = mf_problem()
    d = torch_solver.FUSED_TBL_D + 1
    prob.Xv[0] = np.zeros((prob.n, d))
    prob.Xv[0][np.arange(prob.n), 7 * np.arange(prob.n)] = 1.0
    prob.freq_v[0] = prob.Xv[0].sum(axis=0)
    prob = dataclasses.replace(
        prob, layout=BlockLayout.make((prob.m,), (d,), False))
    params["H"] = {f12: np.random.default_rng(1).normal(
        scale=0.05, size=(d, prob.hp.k)) for f12 in params["H"]}
    solver, state = build_port(prob, params)
    meta = solver.meta
    assert meta.ident_v == (False,) and meta.fused_v == (False,)
    assert solver.data["xf_v"][0].feat_ptr.numel() == d + 1
    before = float(solver.objective(state))
    state = solver.epoch(state)
    assert float(solver.objective(state)) < before
    ref = oracle.oracle_epoch(prob, params)
    f12 = prob.layout.cross_blocks()[0].f12
    np.testing.assert_allclose(state["params"][f12]["H"].numpy(),
                               ref["H"][f12], rtol=1e-6, atol=1e-9)


def test_ghost_ids_are_rejected_when_the_list_is_built():
    rng = np.random.default_rng(6)
    idx, val = _field(rng, 10, 6)
    idx[2, 1] = 6
    with pytest.raises(ValueError, match="outside"):
        feature_major(idx, val, 6)


def test_wide_eval_matches_jax(low_cap):
    """The evaluator's user projections on an FM layout above the cap:
    the port (B8's plain version) against the JAX Evaluator."""
    prob, params = wide_problem("fm_self", seed=7)
    lay, m, n = prob.layout, prob.m, prob.n
    assert lay.Du[0] > CAP
    rng = np.random.default_rng(8)
    Q = {b.f12: prob.Xv[b.fj] @ params["H"][b.f12] for b in lay.cross_blocks()}
    bt = rng.normal(size=n) * 0.1
    popular = rng.random(n)
    popular /= popular.sum()
    va_labels = [np.nonzero(prob.pos[i])[0] for i in range(m)]
    m_pad = m + 3
    pads = [dense_to_padded(X, m_pad) for X in prob.Xu]
    row_nnz = sum((X != 0).sum(axis=1) for X in prob.Xu).astype(np.int32)
    uva = PaddedFields(
        m=m_pad, m_true=m, f=len(prob.Xu),
        Ds=tuple(X.shape[1] for X in prob.Xu),
        idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
        freq=tuple(np.ones(X.shape[1]) for X in prob.Xu),
        row_nnz=np.concatenate([row_nnz, np.zeros(3, np.int32)]))
    jmeta, jdata = jax_eval.make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=jnp.float64)
    jgot = jax_eval.Evaluator(jmeta, jdata, chunk=5).validate(
        {b.f12: {"W": jnp.asarray(params["W"][b.f12]),
                 "H": jnp.asarray(params["H"][b.f12])}
         for b in lay.all_blocks()},
        {f: jnp.asarray(q) for f, q in Q.items()}, jnp.asarray(bt))
    tmeta, tdata = torch_eval.make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=torch.float64, device="cpu")
    kernels.reset_launch_counts()
    tgot = torch_eval.Evaluator(tmeta, tdata, chunk=5).validate(
        {b.f12: {"W": torch.from_numpy(params["W"][b.f12]),
                 "H": torch.from_numpy(params["H"][b.f12])}
         for b in lay.all_blocks()},
        {f: torch.from_numpy(q) for f, q in Q.items()}, torch.from_numpy(bt))
    assert sum(kernels.launch_counts().values()) == 0
    assert set(tgot) == set(jgot)
    for key, val in jgot.items():
        np.testing.assert_allclose(tgot[key], val, rtol=1e-10, atol=1e-12,
                                   err_msg=key)
