"""The port's solver against the fp64 oracle and the JAX solver.

The first problems are one-class MF with --ns: one identity user-id field,
one identity item-id field, one cross block.  The FFM problems add a small
feature field per side (the fused table passes) and self blocks; FM has one
mixed field per side.  CG is plain (passed explicitly: conftest.make_problem
defaults to jacobi).  Both solvers start from the same numpy tables; the JAX
solver runs its k-major and fused table kernels in interpret mode with the
per-solve pregather forced, which is the path the port mirrors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_to_padded, make_problem, oracle_params_to_jax
from one_class_ffm_tpu.data.dataset import PaddedFields, PaddedLabels
from one_class_ffm_tpu.solver import jax_solver, oracle
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops.sparse_ops import gather_blocked_rows
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import (
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)

BM = 4  # rows per block at toy size


def mf_problem(seed=0, m=13, n=9, k=3, **kw):
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=m, n=n, Du=(m,), Dv=(n,),
                                self_side=False, cg_precond="none", k=k, **kw)
    prob.Xu[0][:] = np.eye(m)
    prob.Xv[0][:] = np.eye(n)
    prob.freq_u[0][:] = 1.0
    prob.freq_v[0][:] = 1.0
    return prob, params


def padded(prob, multiple=4):
    """Host padded views of an OracleProblem (rows and nnz rounded up)."""
    def up(x):
        return -(-x // multiple) * multiple

    def side(Xs, freqs, mp):
        pads = [dense_to_padded(X, mp) for X in Xs]
        nnz = sum((X != 0).sum(axis=1) for X in Xs)
        return PaddedFields(
            m=mp, m_true=Xs[0].shape[0], f=len(Xs),
            Ds=tuple(X.shape[1] for X in Xs),
            idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
            freq=tuple(np.asarray(f, np.float64) for f in freqs),
            row_nnz=np.concatenate([nnz, np.zeros(mp - len(nnz))])
            .astype(np.int32))

    m, n = prob.m, prob.n
    u = side(prob.Xu, prob.freq_u, up(m))
    v = side(prob.Xv, prob.freq_v, up(n))
    uu, vv = np.nonzero(prob.pos)
    nnz = up(uu.size + 3)
    pu = np.full(nnz, m, np.int32)
    pv = np.full(nnz, n, np.int32)
    pw = np.zeros(nnz)
    pu[: uu.size], pv[: uu.size], pw[: uu.size] = uu, vv, 1.0
    cu, cv = np.zeros(u.m), np.zeros(v.m)
    np.add.at(cu, uu, 1.0)
    np.add.at(cv, vv, 1.0)
    y = PaddedLabels(nnz=nnz, nnz_true=uu.size, u=pu, v=pv, w=pw,
                     count_u=cu, count_v=cv)
    return u, v, y


def build_port(prob, params, dtype=torch.float64):
    u, v, y = padded(prob)
    meta, data = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=dtype, blocked_bm=BM,
        device="cpu")
    solver = torch_solver.FFMSolver(meta, data)
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    state = solver.refresh_caches(
        {"params": params_from_numpy(p_np, "cpu", dtype)})
    return solver, state


def build_jax(prob, params, monkeypatch):
    monkeypatch.setenv("OCFFM_KT", "interpret")
    monkeypatch.setenv("OCFFM_FUSED_TBL", "interpret")
    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "1")
    u, v, y = padded(prob)
    meta, data = jax_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=jnp.float64, blocked_bm=BM)
    solver = jax_solver.FFMSolver(meta, data)
    assert solver.kt_u and solver.kt_v and solver.blk_yt
    assert solver.pregather_u and solver.pregather_v
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    return solver, state


def test_device_data_matches_jax():
    prob, _ = mf_problem()
    u, v, y = padded(prob)
    _, jd = jax_solver.make_device_data(u, v, y, prob.layout, prob.hp,
                                        dtype=jnp.float64, blocked_bm=BM)
    meta, td = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=BM,
        device="cpu")
    assert meta.ident_u == (True,) and meta.ident_v == (True,)
    assert td["xf_u"] == (None,) and td["xf_v"] == (None,)
    # the port's own keys: the feature-major lists and each row's run of
    # slots, which a binary search over the JAX package's owners finds
    port_only = {"xf_u", "xf_v", "blk_u_runs", "blk_v_runs"}
    assert set(td) - port_only <= set(jd)
    for side in ("u", "v"):
        own = np.asarray(jd[f"blk_{side}_own"])
        runs = td[f"blk_{side}_runs"].numpy()
        for b in range(own.shape[0]):
            np.testing.assert_array_equal(
                runs[b], np.searchsorted(own[b], np.arange(BM + 1)))
    for key, val in td.items():
        if key in port_only:
            continue
        vals = val if isinstance(val, tuple) else (val,)
        refs = jd[key] if isinstance(jd[key], tuple) else (jd[key],)
        assert len(vals) == len(refs), key
        for a, b in zip(vals, refs):
            assert (a is None) == (b is None), key  # colsq of a non-fused field
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=key)


def test_refresh_caches_match_jax(monkeypatch):
    prob, params = mf_problem()
    _, tst = build_port(prob, params)
    _, jst = build_jax(prob, params, monkeypatch)
    f12 = prob.layout.cross_blocks()[0].f12
    for key in ("P", "Q"):
        np.testing.assert_allclose(tst[key][f12].numpy(),
                                   np.asarray(jst[key][f12]), rtol=1e-12)
    for key in ("a", "b", "yt_u", "yt_v"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-12, atol=1e-15, err_msg=key)


@pytest.mark.parametrize("first", [True, False])
def test_gradient_and_hv_match_oracle(first):
    prob, params = mf_problem()
    solver, state = build_port(prob, params)
    b = prob.layout.cross_blocks()[0]
    B1 = state["Q"][b.f12] if first else state["P"][b.f12]
    pre = "blk_u_" if first else "blk_v_"
    rows = gather_blocked_rows(B1, solver.data[pre + "take"])
    G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
    G = solver._grad_cross(state, b, first, rows)
    np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8, atol=1e-10)
    V = np.random.default_rng(3).normal(size=G_ref.shape)
    hv = solver._hv_cross(state, b, first, rows)
    np.testing.assert_allclose(hv(torch.from_numpy(V)).numpy(), hv_ref(V),
                               rtol=1e-8, atol=1e-10)


def test_objective_and_stream_residual_match_oracle():
    prob, params = mf_problem()
    solver, state = build_port(prob, params)
    np.testing.assert_allclose(float(solver.objective(state)),
                               oracle.objective(prob, params), rtol=1e-9)
    yh = oracle.predict_dense(prob, params)
    uu, vv = np.nonzero(prob.pos)
    np.testing.assert_allclose(solver.yt_stream(state).numpy()[: uu.size],
                               yh[uu, vv] - 1.0, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(omega=1.0, r=0.0),
                                dict(lam=0.5, k=4)])
def test_two_epochs_match_oracle(kw):
    prob, params = mf_problem(**kw)
    solver, state = build_port(prob, params)
    ref = params
    for _ in range(2):
        ref = oracle.oracle_epoch(prob, ref)
        state = solver.epoch(state)
    for f12 in ref["W"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                state["params"][f12][name].numpy(), ref[name][f12],
                rtol=1e-6, atol=1e-9, err_msg=f"{name} {f12}")
    np.testing.assert_allclose(float(solver.objective(state)),
                               oracle.objective(prob, ref), rtol=1e-8)


def test_two_epochs_match_jax_kt(monkeypatch):
    prob, params = mf_problem(seed=4)
    tsolver, tst = build_port(prob, params)
    jsolver, jst = build_jax(prob, params, monkeypatch)
    for _ in range(2):
        tst, t_it = tsolver.epoch_stats(tst)
        jst, j_it = jsolver.epoch_stats(jst)
        np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
        assert t_it.sum() > 0
    for f12 in jst["params"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                tst["params"][f12][name].numpy(),
                np.asarray(jst["params"][f12][name]), rtol=1e-9, atol=1e-12)
    for key in ("yt_u", "yt_v", "a", "b"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(float(tsolver.objective(tst)),
                               float(jsolver.objective(jst)), rtol=1e-10)


def test_cache_sasb_matches_jax(monkeypatch):
    prob, params = mf_problem()
    tsolver, tst = build_port(prob, params)
    jsolver, jst = build_jax(prob, params, monkeypatch)
    for got, ref in zip(tsolver._cache_sasb(tst["P"], tst["Q"]),
                        jsolver._cache_sasb(jst["P"], jst["Q"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_objective_decreases_and_epoch_launches_nothing_on_cpu():
    prob, params = mf_problem(seed=2, m=21, n=14)
    solver, state = build_port(prob, params)
    kernels.reset_launch_counts()
    losses = [float(solver.objective(state))]
    for _ in range(3):
        state = solver.epoch(state)
        losses.append(float(solver.objective(state)))
    assert all(b <= a + 1e-12 for a, b in zip(losses, losses[1:]))
    assert losses[-1] < losses[0]
    assert sum(kernels.launch_counts().values()) == 0


def test_init_draws_from_the_reference_law():
    prob, params = mf_problem(k=4)
    solver, _ = build_port(prob, params, dtype=torch.float32)
    s1 = solver.init(torch.Generator().manual_seed(7))
    s2 = solver.init(torch.Generator().manual_seed(7))
    bound = 0.1 / np.sqrt(4)
    for f12, blk in s1["params"].items():
        for name, t in blk.items():
            assert t.dtype == torch.float32
            assert float(t.abs().max()) <= bound
            assert float(t.abs().min()) > 0.0
            assert torch.equal(t, s2["params"][f12][name])


def test_params_numpy_round_trip():
    rng = np.random.default_rng(0)
    p = {3: {"W": rng.normal(size=(5, 2)), "H": rng.normal(size=(4, 2))}}
    back = params_to_numpy(params_from_numpy(p, "cpu", torch.float64))
    np.testing.assert_array_equal(back[3]["W"], p[3]["W"])
    bf = params_to_numpy(params_from_numpy(p, "cpu", torch.bfloat16))
    assert bf[3]["H"].dtype == np.float32
    np.testing.assert_allclose(bf[3]["H"], p[3]["H"], rtol=1e-2)


def _skewed_problem():
    """Four power users hold most positives: beyond the u side's pad budget,
    and too few entries each to fill the default 512-slot head chunks."""
    prob, params = mf_problem(m=64, n=40, density=0.05)
    prob.pos[:4, :] = True
    return prob, params


# self blocks, feature fields of any width, Jacobi, the head tier, the
# plain COO positive passes and the shard-aligned layout on a data mesh run
# now (tests/test_torch_jacobi.py holds Jacobi, tests/test_torch_two_tier.py
# the head tier, tests/test_torch_coo.py the COO passes,
# tests/test_torch_sharding.py the mesh); the case holds what still raises:
# a mesh over the flat layout (the JAX package's sharded fallback)
OUT_OF_SLICE = {
    "mesh": dict(mesh=object()),
}


ROADMAP_ITEM = {"mesh": "A11b"}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_configs_raise(case):
    kw = OUT_OF_SLICE[case]
    prob, params = _skewed_problem() if kw.get("skewed") else mf_problem()
    u, v, y = padded(prob)
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP {ROADMAP_ITEM[case]}"):
        meta, data = torch_solver.make_device_data(
            u, v, y, prob.layout, prob.hp, dtype=torch.float64,
            blocked_bm=kw.get("blocked_bm", BM), device="cpu")
        torch_solver.FFMSolver(meta, data, mesh=kw.get("mesh"))


# the configurations that once raised (both COO; a skewed side that even the
# head tier rejects falls back to COO) beside those that never did:
# (skewed?, blocked_bm, head_chunk)
LAYOUT_CASES = {
    "skew_without_head_chunk": (True, BM, 0),
    "no_layout": (False, 0, 512),
    "unskewed": (False, BM, 512),
    "two_tier": (True, BM, 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_sides_take_the_layouts_jax_takes(case, monkeypatch):
    """Each side's blocked layout or plain COO passes as the JAX package's
    ``make_device_data`` decides (``blocked_bm_u`` / ``blocked_bm_v``, the
    head tiers under OCFFM_HEAD_CHUNK), and the solver builds on them."""
    skewed, bm, hc = LAYOUT_CASES[case]
    prob, _ = _skewed_problem() if skewed else mf_problem()
    u, v, y = padded(prob)
    meta, data = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=bm,
        head_chunk=hc, device="cpu")
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", str(hc))
    jmeta, jdata = jax_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=jnp.float64, blocked_bm=bm)
    assert (meta.blocked_bm_u, meta.blocked_bm_v) == (jmeta.blocked_bm_u,
                                                      jmeta.blocked_bm_v)
    for s in ("u", "v"):
        assert (f"blk_{s}_hd_row" in data) == (f"blk_{s}_hd_row" in jdata)
        assert ("coo_" + s in data) == (
            not (meta.blocked_bm_u if s == "u" else meta.blocked_bm_v))
    want = {"skew_without_head_chunk": (0, BM), "no_layout": (0, 0),
            "unskewed": (BM, BM), "two_tier": (BM, BM)}[case]
    assert (meta.blocked_bm_u, meta.blocked_bm_v) == want
    torch_solver.FFMSolver(meta, data)


# ---------------------------------------------------------------------------
# FFM / FM: small-D feature fields (fused table passes) and self blocks
# ---------------------------------------------------------------------------


def _identity_field(prob, side: str):
    """Make field 0 of a side an identity id field, as the data pipeline
    builds it."""
    Xs, fr = (prob.Xu, prob.freq_u) if side == "u" else (prob.Xv, prob.freq_v)
    Xs[0][:] = np.eye(Xs[0].shape[0])
    fr[0][:] = 1.0


FFM_CASES = ("ffm_self", "ffm_ns", "mf_self", "ffm_freq", "fm")


def ffm_problem(case, seed=1, m=13, n=9, k=3):
    """ffm_self / ffm_ns: the bench's shape at toy size, an identity id
    field and a small feature field per side, with or without self blocks;
    mf_self: identity fields with self blocks; ffm_freq: two feature fields
    per side with frequency-scaled lambda; fm: one mixed field per side
    (the id columns and features in one field)."""
    rng = np.random.default_rng(seed)
    kw = dict(m=m, n=n, k=k, cg_precond="none")
    if case in ("ffm_self", "ffm_ns"):
        prob, params = make_problem(rng, Du=(m, 5), Dv=(n, 4), max_nnz=3,
                                    self_side=case == "ffm_self", **kw)
    elif case == "mf_self":
        prob, params = make_problem(rng, Du=(m,), Dv=(n,), self_side=True,
                                    **kw)
    elif case == "ffm_freq":
        return make_problem(rng, freq=True, self_side=True, **kw)
    else:
        prob, params = make_problem(rng, Du=(m + 6,), Dv=(n + 5,),
                                    max_nnz=2, self_side=True, **kw)
        for Xs, fr, rows in ((prob.Xu, prob.freq_u, m),
                             (prob.Xv, prob.freq_v, n)):
            Xs[0][:, :rows] = np.eye(rows)
            fr[0][:] = Xs[0].astype(bool).sum(axis=0)
        return prob, params
    _identity_field(prob, "u")
    _identity_field(prob, "v")
    return prob, params


def test_ffm_device_data_matches_jax():
    """Fused-field flags and the feature-major lists: a field qualifies as
    the JAX package's does (its transposed copy exists), and each list
    holds that field's X."""
    prob, _ = ffm_problem("ffm_self")
    u, v, y = padded(prob)
    _, jd = jax_solver.make_device_data(u, v, y, prob.layout, prob.hp,
                                        dtype=jnp.float64, blocked_bm=BM)
    meta, td = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=BM,
        device="cpu")
    assert meta.ident_u == (True, False) and meta.fused_u == (False, True)
    assert meta.ident_v == (True, False) and meta.fused_v == (False, True)
    for s, pf in (("u", u), ("v", v)):
        for fi, (xf, xt) in enumerate(zip(td[f"xf_{s}"], jd[f"xt_{s}"])):
            assert (xf is None) == (xt is None), (s, fi)
            if xf is None:
                continue
            X = np.zeros((pf.m, pf.Ds[fi]))
            idx_t, val_t = np.asarray(xt[0]), np.asarray(xt[1])
            np.add.at(X, (np.tile(np.arange(pf.m), idx_t.shape[0]),
                          idx_t.ravel()), val_t.ravel())
            got = np.zeros_like(X)
            np.add.at(got, (xf.row.numpy(), _entry_features(xf)),
                      xf.val.numpy())
            np.testing.assert_array_equal(got, X)


def _entry_features(xf):
    """The feature of every entry of a feature-major list."""
    per_chunk = np.diff(xf.chunk_ptr.numpy())
    chunk_feat = np.repeat(np.arange(xf.feat_ptr.numel() - 1),
                           np.diff(xf.feat_ptr.numpy()))
    return np.repeat(chunk_feat, per_chunk)


@pytest.mark.parametrize("case", FFM_CASES)
def test_ffm_two_epochs_match_oracle(case):
    prob, params = ffm_problem(case)
    solver, state = build_port(prob, params)
    assert any(solver.meta.fused_u + solver.meta.fused_v) or case == "mf_self"
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


def test_ffm_gradient_and_hv_match_oracle():
    """Every block side of FFM with self blocks: identity halves (plain
    torch) and small-D halves (the fused table passes)."""
    prob, params = ffm_problem("ffm_self")
    solver, state = build_port(prob, params)
    sa, sb = solver.sasb(state)
    V_rng = np.random.default_rng(3)
    kinds = set()
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G, hv, _ = solver.grad_and_hv(state, b, first, sa, sb)
            G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8,
                                       atol=1e-10, err_msg=f"{b.f12}")
            V = V_rng.normal(size=G_ref.shape)
            np.testing.assert_allclose(hv(torch.from_numpy(V)).numpy(),
                                       hv_ref(V), rtol=1e-8, atol=1e-10,
                                       err_msg=f"{b.f12}")
            kinds.add((b.kind, solver._x(b, first)[2] is not None))
    assert kinds == {(kind, fused) for kind in ("uu", "uv", "vv")
                     for fused in (False, True)}


@pytest.mark.parametrize("case", ["ffm_self", "fm"])
def test_ffm_two_epochs_match_jax_fused(case, monkeypatch):
    """Against the JAX solver on its fused table kernels (interpret mode):
    equal per-solve CG iteration counts and matching tables."""
    prob, params = ffm_problem(case, seed=4)
    tsolver, tst = build_port(prob, params)
    jsolver, jst = build_jax(prob, params, monkeypatch)
    assert jsolver.fused_tbl and jsolver.fused_interpret
    fused = [(b.f12, first) for b in prob.layout.all_blocks()
             for first in (True, False) if tsolver._x(b, first)[2] is not None]
    assert fused
    for f12, first in fused:
        b = next(x for x in prob.layout.all_blocks() if x.f12 == f12)
        dim = b.d1 if first else b.d2
        assert jsolver._fused_tbl_side(b, first, dim) is not None
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


def test_hv_cross_hands_the_static_runs_to_b1_and_b4(monkeypatch):
    """Every cross block side's Hv passes the layout's static row runs
    (``blk_*_runs``) to its kernel: B1 on the identity halves, B4 on the
    small-D ones; the CPU dispatch ignores them and the Hv is unchanged."""
    prob, params = ffm_problem("ffm_ns")
    solver, state = build_port(prob, params)
    seen = []

    def recording(name, fn):
        def call(*args, runs=None, **kw):
            seen.append((name, runs))
            return fn(*args, runs=runs, **kw)
        return call

    for name in ("pos_hv_blocked", "pos_hv_tbl"):
        monkeypatch.setattr(torch_solver, name,
                            recording(name, getattr(torch_solver, name)))
    rng = np.random.default_rng(6)
    names = set()
    for b in prob.layout.cross_blocks():
        for first in (True, False):
            _, hv, _ = solver.grad_and_hv(state, b, first, None, None)
            _, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            seen.clear()
            V = rng.normal(size=(b.d1 if first else b.d2, prob.hp.k))
            np.testing.assert_allclose(hv(torch.from_numpy(V)).numpy(),
                                       hv_ref(V), rtol=1e-8, atol=1e-10)
            want = ("pos_hv_tbl" if solver._fused(b, first)
                    else "pos_hv_blocked")
            runs = solver.data["blk_u_runs" if first else "blk_v_runs"]
            assert len(seen) == 1 and seen[0][0] == want, (b.f12, first)
            assert seen[0][1] is runs, (b.f12, first)
            names.add(want)
    assert names == {"pos_hv_blocked", "pos_hv_tbl"}


def test_step_and_self_gradient_hand_the_static_runs_to_b3_and_b7(
        monkeypatch):
    """The step's residual gap (B3, on every cross block side) and the fused
    self-block gradient (B7, with and without the Jacobi dd output) pass
    the layout's static row runs (``blk_*_runs``) to their kernels; the
    CPU dispatch ignores them and the epoch is unchanged."""
    prob, params = ffm_problem("ffm_self")
    solver, state = build_port(prob, params)
    ref = solver.epoch(state)
    seen = []

    def recording(name, fn):
        def call(*args, runs=None, **kw):
            seen.append((name, runs, kw.get("dd") is not None))
            return fn(*args, runs=runs, **kw)
        return call

    for name in ("pos_gap_blocked", "grad_self_tbl"):
        monkeypatch.setattr(torch_solver, name,
                            recording(name, getattr(torch_solver, name)))
    got = solver.epoch(state)
    for key in ("P", "Q"):
        for f12 in ref[key]:
            assert torch.equal(got[key][f12], ref[key][f12]), (key, f12)
    sa, sb = solver.sasb(state)
    for b in prob.layout.all_blocks():
        if b.kind != "uv" and solver._fused(b, True):
            solver._grad_self(state, b, True, sa, sb, want_diag=True)
    names = {(name, diag) for name, _, diag in seen}
    assert names == {("pos_gap_blocked", False), ("grad_self_tbl", False),
                     ("grad_self_tbl", True)}, names
    runs = (solver.data["blk_u_runs"], solver.data["blk_v_runs"])
    assert all(any(r is x for x in runs) for _, r, _ in seen)


def test_cross_gradient_hands_the_static_runs_to_b5(monkeypatch):
    """The fused cross-block gradient (B5, with and without the Jacobi
    w_blk output) passes the layout's static row runs (``blk_*_runs``) to
    its kernel on both sides; the CPU dispatch ignores them and the
    gradient still matches the oracle's."""
    prob, params = ffm_problem("ffm_ns")
    solver, state = build_port(prob, params)
    seen = []

    def recording(fn):
        def call(*args, runs=None, **kw):
            seen.append((runs, kw.get("w_blk") is not None))
            return fn(*args, runs=runs, **kw)
        return call

    monkeypatch.setattr(torch_solver, "grad_cross_tbl",
                        recording(torch_solver.grad_cross_tbl))
    sides = set()
    for b in prob.layout.cross_blocks():
        for first in (True, False):
            if not solver._fused(b, first):
                continue
            B1 = state["Q"][b.f12] if first else state["P"][b.f12]
            pre = "blk_u_" if first else "blk_v_"
            rows = gather_blocked_rows(B1, solver.data[pre + "take"])
            seen.clear()
            G = solver._grad_cross(state, b, first, rows)
            G_ref, _ = oracle.grad_and_hv(prob, params, b, first)
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8,
                                       atol=1e-10)
            G_d, _ = solver._grad_cross(state, b, first, rows,
                                        with_diag_pos=True)
            assert torch.equal(G_d, G)
            runs = solver.data[pre + "runs"]
            assert [d for _, d in seen] == [False, True], (b.f12, first)
            assert all(r is runs for r, _ in seen), (b.f12, first)
            sides.add(first)
    assert sides == {True, False}
