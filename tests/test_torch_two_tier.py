"""The two-tier head tier of a popularity-skewed side, in the port.

The head ops against the JAX package's (``sparse_ops.head_*``), the chunk
table's row sums against a scatter-add, the device data's head keys, the
head carry and the solver on skewed problems (a power item every user
likes, and in the ``both`` cases a power user who likes every item) against
the fp64 oracle, the JAX two-tier solver (its k-major and fused kernels in
interpret mode, ``OCFFM_HEAD_CHUNK=8``) and the JAX plain COO solver
(``blocked_bm=0``), over MF, FFM (an identity and a fused field per side)
and FM (one wide field per side under a lowered fused-table cap), plain and
Jacobi CG.  Float64 unless a test says otherwise; CG is passed
explicitly."""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_problem, oracle_params_to_jax
from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_tpu.solver import jax_solver, oracle
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops
from one_class_ffm_torch.ops.layout import (
    feature_major,
    head_chunk_table,
    make_blocked_layout,
)
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import params_from_numpy
from test_torch_imports import ROOT
from test_torch_solver import BM, _identity_field, padded

torch.set_num_threads(1)

CHUNK = 8  # head chunk width at toy size (tests/test_two_tier.py's)
CAP = 8  # the lowered fused-table cap of the FM cases
# f64 / f32 against the JAX ops: sums in other orders; bf16: one ulp of the
# largest output (the port's bf16 op tests' bound, tests/test_torch_jacobi.py)
RTOL = {torch.float64: 1e-9, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def J(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    if t.is_floating_point():
        return jnp.asarray(t.numpy(), JDT[t.dtype])
    return jnp.asarray(t.numpy())


def _max_rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got.double().numpy() - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# the head ops against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture
def head():
    """A head tier at toy size: 3 head rows of 10 owning 3, 1 and 2 chunks,
    then 2 pad chunks (hd_loc 0, no valid slot, zero weight), as
    ``make_blocked_layout`` lays them out; a fused field of 3 slots, a
    repeated feature id across the head rows."""
    rng = np.random.default_rng(11)
    nch, chunk, k, num, d, p = 8, 6, 5, 10, 9, 3
    hd_rows = np.array([1, 4, 7])
    hd_loc = np.array([0, 0, 0, 1, 2, 2, 0, 0])
    valid = np.ones((nch, chunk), bool)
    valid[2, 4:] = valid[5, 1:] = False
    valid[6:] = False
    xh_idx = rng.integers(0, d, size=(3, p)).astype(np.int32)
    xh_idx[:, 0] = 2
    return dict(
        hd_rows=hd_rows, hd_loc=hd_loc, hd_row=hd_rows[hd_loc], valid=valid,
        c=rng.normal(size=(nch, chunk)) * valid,
        w=valid.astype(np.float64), rows=rng.normal(size=(nch, chunk, k)),
        phi=rng.normal(size=(num, k)), V=rng.normal(size=(d, k)),
        xh_idx=xh_idx, xh_val=rng.uniform(0.5, 1.5, size=(3, p)), num=num,
        d=d, tab=T(head_chunk_table(hd_loc, valid, 3)))


def _kt(rows):
    """The JAX head stream's k-major layout (NCH, k, CHUNK)."""
    return jnp.swapaxes(J(rows), 1, 2)


@pytest.mark.parametrize("dt", list(RTOL), ids=str)
def test_head_ops_match_jax(head, dt):
    h = head
    c, w, rows = (T(h[x], dt) for x in ("c", "w", "rows"))
    phi, V, xh_val = (T(h[x], dt) for x in ("phi", "V", "xh_val"))
    hd_row, hd_rows = T(h["hd_row"]).int(), T(h["hd_rows"])
    xh_idx, tab, num = T(h["xh_idx"]), h["tab"], h["num"]
    jrow = J(hd_row)
    out = {
        "head_chunk_sums": (tops.head_chunk_sums(c, rows),
                            jops.head_chunk_sums(J(c), _kt(rows))),
        "head_pq": (tops.head_pq(phi[:8], rows),
                    jops.head_pq(J(phi[:8]), _kt(rows))),
        "head_seg_sum": (tops.head_seg_sum(c, tab, hd_rows, num),
                         jops.head_seg_sum(J(c), jrow, num)),
        "head_hv": (tops.head_hv(phi, rows, tops.storage_scale(w, 0.75),
                                 hd_row, tab, hd_rows, num),
                    jops.head_hv(J(phi), _kt(rows), J(w), jrow, num, 0.75)),
        # the port's head_project is B8 on the head rows' field data
        "head_project": (tops.project(xh_idx, xh_val, V),
                         jops.head_project(J(V), J(xh_idx), J(xh_val))),
    }
    z, zq = tops.head_scatter(c, rows, tab, hd_rows, num, diag_w_hd=w * 0.5)
    rz, rq = jops.head_scatter(J(c), _kt(rows), jrow, num,
                               diag_w_hd=J(w * 0.5))
    out["head_scatter"] = (z, rz)
    out["head_scatter diag"] = (zq, rq)
    assert torch.equal(tops.head_scatter(c, rows, tab, hd_rows, num), z)
    zh = tops.project(xh_idx, xh_val, V)
    fm = feature_major(h["xh_idx"], T(h["xh_val"], dt).double().numpy(),
                       h["d"])
    xh = torch_solver.FeatureMajor(
        row=T(fm.row), val=T(fm.val, dt), chunk_ptr=T(fm.chunk_ptr),
        feat_ptr=T(fm.feat_ptr), n_rows=fm.n_rows,
        val_sq=T(fm.val, dt) * T(fm.val, dt))
    # and its head_tbl_scatter the X^T stage through their list
    out["head_tbl_scatter"] = (tops.scatter(xh, zh),
                               jops.head_tbl_scatter(J(zh), J(xh_idx),
                                                     J(xh_val), h["d"]))
    out["head_tbl_scatter X^2"] = (
        tops.scatter(xh, zh, squared=True),
        jops.head_tbl_scatter(J(zh), J(xh_idx), J(xh_val * xh_val), h["d"]))
    for name, (got, ref) in out.items():
        assert got.dtype == dt, name
        assert tuple(got.shape) == tuple(ref.shape), name
        if dt == torch.bfloat16:
            assert _max_rel(got, ref.astype(jnp.float32)) <= RTOL[dt], name
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL[dt], atol=RTOL[dt] * 1e-3,
                                       err_msg=name)


def test_chunk_table_row_sums_match_scatter_add(head):
    """Each head row's chunks summed through the table equal the JAX ops'
    ``.at[hd_loc].add`` of the chunk sums (a pad chunk's is 0); the pad
    chunks are in no row and every real chunk is in its own row once, in
    chunk order."""
    h = head
    tab = h["tab"].numpy()
    assert tab.shape == (3, 3)
    np.testing.assert_array_equal(tab, [[0, 1, 2], [3, 8, 8], [4, 5, 8]])
    z = np.random.default_rng(1).normal(size=(8, 4))
    z[6:] = 0.0  # a pad chunk's sum: its slots weigh 0
    got = tops.head_row_sums(T(z), h["tab"]).numpy()
    ref = np.asarray(jnp.zeros((3, 4)).at[J(T(h["hd_loc"]))].add(J(T(z))))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    s = z[:, 0]
    np.testing.assert_allclose(tops.head_row_sums(T(s), h["tab"]).numpy(),
                               ref[:, 0], rtol=1e-12)


def test_chunk_table_refuses_chunks_out_of_row_order(head):
    """The table reads each head row's chunks as one run, the runs in row
    order and the pads last, as ``make_blocked_layout`` lays them out: a
    layout that breaks either is refused, not summed wrongly."""
    h = head
    loc = h["hd_loc"].copy()
    loc[[1, 3]] = loc[[3, 1]]  # row 0's run split by a chunk of row 1
    with pytest.raises(ValueError, match="one run per head row"):
        head_chunk_table(loc, h["valid"], 3)
    valid = h["valid"].copy()
    valid[[4, 6]] = valid[[6, 4]]  # a pad chunk before a real one
    with pytest.raises(ValueError, match="pad chunks last"):
        head_chunk_table(h["hd_loc"], valid, 3)


def test_chunk_table_of_a_layout():
    """On a layout's head tier (the v side's case: unsorted segments, pads
    dropped) the table lists each head row's chunks, all of them, and no
    pad chunk."""
    rng = np.random.default_rng(3)
    cnt = rng.integers(1, 5, size=24)
    cnt[0], cnt[7], cnt[9] = 40, 25, 30
    seg = np.repeat(np.arange(24), cnt)
    perm = rng.permutation(seg.size)
    out = make_blocked_layout(seg[perm], np.arange(seg.size), 24, 4,
                              drop=np.zeros(seg.size, bool), head_chunk=8)
    assert "hd_row" in out
    nh = len(out["hd_rows"])
    tab = head_chunk_table(out["hd_loc"], out["hd_valid"], nh)
    nch = out["hd_row"].shape[0]
    real = out["hd_valid"].any(axis=1)
    assert (~real).any()  # the chunk count pads to a multiple of 8
    listed = tab[tab < nch]
    np.testing.assert_array_equal(np.sort(listed), np.nonzero(real)[0])
    for h in range(nh):
        row = tab[h][tab[h] < nch]
        assert np.all(np.diff(row) > 0)
        assert np.all(out["hd_loc"][row] == h)
        assert out["hd_valid"][row].sum() == np.bincount(seg)[
            out["hd_rows"][h]]


# ---------------------------------------------------------------------------
# skewed problems
# ---------------------------------------------------------------------------

CASES = ("mf", "ffm", "fm")


def skewed_problem(case: str, both: bool = False, jacobi: bool = False,
                   seed: int = 1, m: int = 40, n: int = 24):
    """A toy problem whose item 0 every user likes (the v side takes the
    head tier at chunk 8); with ``both`` user 0 also likes every item (the
    u side too).  mf: identity id fields, no self blocks; ffm: an identity
    and a small feature field per side (fused), self blocks; fm: one mixed
    field per side with self blocks, wide under the lowered cap."""
    rng = np.random.default_rng(seed)
    kw = dict(m=m, n=n, k=3, density=0.08,
              cg_precond="jacobi" if jacobi else "none")
    if case == "mf":
        prob, params = make_problem(rng, Du=(m,), Dv=(n,), self_side=False,
                                    **kw)
        _identity_field(prob, "u")
        _identity_field(prob, "v")
    elif case == "ffm":
        prob, params = make_problem(rng, Du=(m, 5), Dv=(n, 4), max_nnz=3,
                                    self_side=True, **kw)
        _identity_field(prob, "u")
        _identity_field(prob, "v")
    else:
        prob, params = make_problem(rng, Du=(m + 6,), Dv=(n + 5,),
                                    max_nnz=2, self_side=True, **kw)
        for Xs, fr, rows in ((prob.Xu, prob.freq_u, m),
                             (prob.Xv, prob.freq_v, n)):
            Xs[0][:, :rows] = np.eye(rows)
            fr[0][:] = Xs[0].astype(bool).sum(axis=0)
    pos = prob.pos.copy()
    pos[:, 0] = True
    if both:
        pos[0, :] = True
    return dataclasses.replace(prob, pos=pos), params


@pytest.fixture
def cap(monkeypatch):
    """Head chunk 8 for the JAX package; the lowered fused cap on both
    sides for FM."""
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", str(CHUNK))

    def apply(case):
        if case == "fm":
            monkeypatch.setattr(torch_solver, "FUSED_TBL_D", CAP)
            monkeypatch.setenv("OCFFM_FUSED_TBL_D", str(CAP))
    return apply


def port(prob, params, dtype=torch.float64):
    u, v, y = padded(prob)
    meta, data = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=dtype, blocked_bm=BM,
        head_chunk=CHUNK, device="cpu")
    solver = torch_solver.FFMSolver(meta, data)
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    state = solver.refresh_caches(
        {"params": params_from_numpy(p_np, "cpu", dtype)})
    return solver, state


def jax_two_tier(prob, params, monkeypatch, blocked_bm=BM):
    """The JAX solver with its kernels in interpret mode and the per-solve
    pregather forced (tests/test_torch_solver.py build_jax); blocked_bm=0
    is its plain COO solver."""
    monkeypatch.setenv("OCFFM_KT", "interpret")
    monkeypatch.setenv("OCFFM_FUSED_TBL", "interpret")
    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "1")
    u, v, y = padded(prob)
    meta, data = jax_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=jnp.float64,
        blocked_bm=blocked_bm)
    solver = jax_solver.FFMSolver(meta, data)
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    return solver, state


def _kinds(solver, prob):
    out = set()
    for b in prob.layout.all_blocks():
        for first in (True, False):
            xf = solver._x(b, first)[2]
            out.add("ident" if xf is None else
                    "fused" if solver._fused(b, first) else "wide")
    return out


KINDS = {"mf": {"ident"}, "ffm": {"ident", "fused"}, "fm": {"wide"}}


@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_device_data_head_keys_match_jax(case, both, cap, monkeypatch):
    """The head keys, the head rows' field data and the head cross-order
    maps equal the JAX package's (OCFFM_HEAD_CHUNK=8); the port's own keys
    hold the head rows and their chunk table."""
    cap(case)
    prob, _ = skewed_problem(case, both)
    u, v, y = padded(prob)
    _, jd = jax_solver.make_device_data(u, v, y, prob.layout, prob.hp,
                                        dtype=jnp.float64, blocked_bm=BM)
    _, td = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=BM,
        head_chunk=CHUNK, device="cpu")
    sides = ("u", "v") if both else ("v",)
    for s in ("u", "v"):
        assert (f"blk_{s}_hd_row" in td) == (s in sides)
        assert (f"blk_{s}_hd_row" in jd) == (s in sides)
    keys = [k for k in td if "_hd_" in k and not k.endswith(("_rows",
                                                             "_tab"))]
    assert len(keys) == 6 * len(sides)
    for key in keys:
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)
    for s in sides:
        pre = f"blk_{s}_hd_"
        hd_row = td[pre + "row"].numpy()
        np.testing.assert_array_equal(
            td[pre + "rows"].numpy()[td[pre + "loc"].numpy()], hd_row)
        tab = td[pre + "tab"].numpy()
        nch = hd_row.shape[0]
        real = np.nonzero(td[pre + "w"].numpy().any(axis=1))[0]
        np.testing.assert_array_equal(np.sort(tab[tab < nch]), real)
        for got, ref in zip(td.get("xh_" + s, ()), jd["xh_" + s]):
            assert (got is None) == (ref is None)
            if got is not None:
                for a, b_ in zip(got, ref):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
        for xf, xh in zip(td.get("xhf_" + s, ()), td.get("xh_" + s, ())):
            assert (xf is None) == (xh is None)
            if xf is not None:  # the list holds the head rows' X
                X = np.zeros((xh[0].shape[0], xf.feat_ptr.numel() - 1))
                np.add.at(X, (np.repeat(np.arange(X.shape[0]),
                                        xh[0].shape[1]),
                              xh[0].numpy().ravel()), xh[1].numpy().ravel())
                got = np.zeros_like(X)
                per_chunk = np.diff(xf.chunk_ptr.numpy())
                feat = np.repeat(np.repeat(
                    np.arange(X.shape[1]), np.diff(xf.feat_ptr.numpy())),
                    per_chunk)
                np.add.at(got, (xf.row.numpy(), feat), xf.val.numpy())
                np.testing.assert_array_equal(got, X)
    # head rows' field data only for a fused field
    assert any(x is not None for x in td["xh_v"]) == (case == "ffm")


@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_refresh_caches_head_carry_matches_jax(case, both, cap,
                                               monkeypatch):
    cap(case)
    prob, params = skewed_problem(case, both)
    tsolver, tst = port(prob, params)
    jsolver, jst = jax_two_tier(prob, params, monkeypatch)
    assert (tsolver.hd_u, tsolver.hd_v) == (jsolver.hd_u, jsolver.hd_v) \
        == (both, True)
    for key in ("yt_u", "yt_v", "yt_v_hd") + (("yt_u_hd",) if both else ()):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-12, atol=1e-15, err_msg=key)
    np.testing.assert_allclose(tsolver.yt_stream(tst).numpy(),
                               np.asarray(jsolver.yt_stream(jst)),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_gradient_hv_and_diagonal_match_oracle(case, both, jacobi, cap):
    """Every block side of a skewed problem: the gradient, Hv and (Jacobi)
    the Hessian diagonal against the fp64 oracle."""
    cap(case)
    prob, params = skewed_problem(case, both, jacobi)
    solver, state = port(prob, params)
    assert solver.hd_v and solver.hd_u == both
    assert _kinds(solver, prob) == KINDS[case]
    sa, sb = solver.sasb(state)
    rng = np.random.default_rng(3)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G, hv, _, _, D = solver.solve_inputs(state, b, first, sa, sb)
            G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            msg = f"{b.f12} {first}"
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8,
                                       atol=1e-10, err_msg=msg)
            V = rng.normal(size=G_ref.shape)
            np.testing.assert_allclose(hv(T(V)).numpy(), hv_ref(V),
                                       rtol=1e-8, atol=1e-10, err_msg=msg)
            if jacobi:
                np.testing.assert_allclose(
                    D.numpy(), oracle.diag_hessian(prob, params, b, first),
                    rtol=1e-8, atol=1e-10, err_msg=msg)
            else:
                assert D is None


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_two_epochs_match_oracle(case, both, jacobi, cap):
    cap(case)
    prob, params = skewed_problem(case, both, jacobi)
    solver, state = port(prob, params)
    assert solver.hd_v and solver.hd_u == both
    kernels.reset_launch_counts()
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
    assert sum(kernels.launch_counts().values()) == 0


def _assert_epochs_match(tsolver, tst, jsolver, jst, epochs=2,
                         counts=True):
    for _ in range(epochs):
        tst, t_it = tsolver.epoch_stats(tst)
        jst, j_it = jsolver.epoch_stats(jst)
        if counts:
            np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
        assert t_it.sum() > 0
    for f12 in jst["params"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                tst["params"][f12][name].numpy(),
                np.asarray(jst["params"][f12][name]), rtol=1e-6, atol=1e-9,
                err_msg=f"{name} {f12}")
    np.testing.assert_allclose(tsolver.yt_stream(tst).numpy(),
                               np.asarray(jsolver.yt_stream(jst)),
                               rtol=1e-6, atol=1e-9)
    return tst, jst


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_two_epochs_match_jax_two_tier(case, both, jacobi, cap,
                                       monkeypatch):
    """Against the JAX two-tier solver (its kernels in interpret mode):
    equal CG counts per solve, tables and the stream residual."""
    cap(case)
    prob, params = skewed_problem(case, both, jacobi, seed=4)
    tsolver, tst = port(prob, params)
    jsolver, jst = jax_two_tier(prob, params, monkeypatch)
    assert (jsolver.hd_u, jsolver.hd_v) == (both, True)
    assert jsolver.kt_u and jsolver.kt_v and jsolver.blk_yt
    assert tsolver.cg_precond == jsolver.cg_precond
    tst, jst = _assert_epochs_match(tsolver, tst, jsolver, jst)
    for key in ("yt_v_hd",) + (("yt_u_hd",) if both else ()):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_epochs_match_plain_coo_jax(case, both, cap, monkeypatch):
    """The split is exact: the port's two-tier epochs equal the JAX plain
    COO solver's (no blocked layout, no head tier) to 1e-6
    (tests/test_two_tier.py holds the JAX two-tier solver the same way)."""
    cap(case)
    prob, params = skewed_problem(case, both, seed=2)
    tsolver, tst = port(prob, params)
    jsolver, jst = jax_two_tier(prob, params, monkeypatch, blocked_bm=0)
    assert not (jsolver.hd_u or jsolver.hd_v)
    assert tsolver.hd_v and tsolver.hd_u == both
    _assert_epochs_match(tsolver, tst, jsolver, jst)


@pytest.mark.parametrize("both", [False, True], ids=["v", "both"])
@pytest.mark.parametrize("case", CASES)
def test_objective_and_head_carry_after_two_epochs(case, both, cap,
                                                   monkeypatch):
    """The objective equals the JAX plain solver's; after two epochs the
    carried residual, head slots included, equals a fresh
    ``refresh_caches`` of the advanced tables."""
    cap(case)
    prob, params = skewed_problem(case, both)
    tsolver, tst = port(prob, params)
    jsolver, jst = jax_two_tier(prob, params, monkeypatch, blocked_bm=0)
    np.testing.assert_allclose(float(tsolver.objective(tst)),
                               float(jsolver.objective(jst)), rtol=1e-10)
    for _ in range(2):
        tst = tsolver.epoch(tst)
    re = tsolver.refresh_caches({"params": tst["params"]})
    for key in ("yt_u", "yt_v", "yt_v_hd") + (("yt_u_hd",) if both else ()):
        np.testing.assert_allclose(re[key].numpy(), tst[key].numpy(),
                                   rtol=1e-8, atol=1e-10, err_msg=key)
    np.testing.assert_allclose(float(tsolver.objective(re)),
                               float(tsolver.objective(tst)), rtol=1e-10)


def test_cross_step_needs_the_head_stream_on_a_two_tier_side():
    """A cross step reads the head gaps from the solve's head stream: on a
    two-tier side (v) a step without it, and on a plain side (u) a step
    with one, is refused instead of indexing past the tail's gaps."""
    prob, params = skewed_problem("mf")
    solver, state = port(prob, params)
    b = prob.layout.cross_blocks()[0]
    sa, sb = solver.sasb(state)
    for first in (True, False):
        _, _, rows_pre, rows_hd, _ = solver.solve_inputs(state, b, first, sa,
                                                         sb)
        assert (rows_hd is None) == first
        S = torch.zeros_like(state["params"][b.f12]["W" if first else "H"])
        wrong = rows_pre if rows_hd is None else None
        with pytest.raises(ValueError, match="head stream"):
            solver._apply_step(state, b, first, S, rows_pre, wrong)


def test_head_chunk_zero_turns_the_split_off(monkeypatch):
    """``head_chunk=0`` leaves a side the blocked builder rejects to the
    plain COO passes, as OCFFM_HEAD_CHUNK=0 does: the skewed v side goes
    COO (no head tier, its list of the stream), the u side stays
    blocked."""
    prob, _ = skewed_problem("mf")
    u, v, y = padded(prob)
    meta, data = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64,
        blocked_bm=BM, head_chunk=0, device="cpu")
    assert (meta.blocked_bm_u, meta.blocked_bm_v) == (BM, 0)
    assert "coo_v" in data and "coo_u" not in data
    assert not any(key.startswith("blk_") and "_hd_" in key for key in data)
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "0")
    jmeta, _ = jax_solver.make_device_data(u, v, y, prob.layout, prob.hp,
                                           dtype=jnp.float64, blocked_bm=BM)
    assert (jmeta.blocked_bm_u, jmeta.blocked_bm_v) == (BM, 0)


# ---------------------------------------------------------------------------
# chip_smoke's skew phases and the command line, on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_skew_rehearsal_on_cpu(capsys):
    """chip_smoke's skewed FFM at toy size (build_padded's zipf draw, 8 rows
    per block, 8-slot chunks): the v side takes the head tier, the kernel
    cases record nothing on the CPU (plain versions), the main-path loop
    trains and validates, every head op is found on the path and runs on
    its recorded arguments, and one epoch repeats bit for bit."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    data = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True,
                                 pop_skew=1.0)
    trainer = chip_smoke.make_trainer(data, "cpu", k=4, blocked_bm=8,
                                      head_chunk=8)
    solver = trainer.solver
    assert solver.hd_v and not solver.hd_u
    chip_smoke.print_static_plan("FFM skew", solver.data)
    out = capsys.readouterr().out
    assert "[data] FFM skew head tier v: " in out
    assert "head tier u" not in out
    state = trainer.init_state()
    names = {n for case in chip_smoke.skew_cases(trainer) for n in case[0]}
    assert names == set(chip_smoke.BLOCKED + chip_smoke.TABLE
                        + chip_smoke.WIDE)
    wide, b, first = chip_smoke.skew_cases(trainer)[3][:3]
    assert set(chip_smoke.WIDE) <= set(wide) and not first
    with chip_smoke.first_calls(names) as seen, chip_smoke.recorded(
            torch_solver, chip_smoke.WIDE, first_only=True) as disp:
        solver._solve_half(state, b, first, *solver.sasb(state))
    assert seen == {}
    # the v side's categorical cross solve first projects the head rows
    # and first scatters through their list: B8 and the X^T stage at the
    # head tier's shapes on the card
    fl = b.f2 - solver.meta.layout.fu
    (idx, val, _), _ = disp["project"][0]
    assert idx is solver.data["xh_v"][fl][0]
    assert disp["scatter"][0][0][0] is solver.data["xhf_v"][fl]
    res = chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.check_main_path(res)
    assert len(res["iters"]) == 3 and all(len(i) == 20 for i in res["iters"])
    ops = chip_smoke.record_head_ops(trainer)
    assert list(ops) == [label for label, _ in chip_smoke.HEAD_OPS]
    nch, chunk = solver.data["blk_v_hd_take"].shape
    for label, (fn, args, kw) in ops.items():
        got = fn(*args, **kw)
        got = got[0] if isinstance(got, tuple) else got
        assert torch.isfinite(got).all(), label
    assert ops["rows_hd gather"][0](*ops["rows_hd gather"][1]).shape == (
        nch, chunk, 4)
    chip_smoke.check_repeatable("ffm-skew", trainer)


@pytest.fixture(scope="module")
def skew_set(tmp_path_factory):
    """FFM text files whose items 0 and 1 every user likes (the v side
    takes the head tier at the default 512-slot chunks and 8 rows per
    block) and a random text model with self blocks."""
    from one_class_ffm_tpu import cli as jax_cli
    from one_class_ffm_tpu.data.synth import SynthSpec, _write_rows, generate

    out = tmp_path_factory.mktemp("skew")
    users, items = generate(SynthSpec(n_users=1500, n_items=64, avg_pos=5.0,
                                      seed=8))
    rng = np.random.default_rng(9)
    tr_rows, va_rows = [], []
    for labels, feats in users:
        labels = [j for j in labels if j > 1]
        rng.shuffle(labels)
        n_va = int(len(labels) * 0.2)
        tr_rows.append((sorted([0, 1] + labels[n_va:]), feats))
        if n_va:
            va_rows.append((sorted(labels[:n_va]), feats))
    item, train, va = (str(out / n) for n in ("items.ffm", "train.ffm",
                                               "va.ffm"))
    _write_rows(item, items, with_labels=False)
    _write_rows(train, tr_rows, with_labels=True)
    _write_rows(va, va_rows, with_labels=True)
    model = str(out / "model.txt")
    assert jax_cli.main([item, train, "-k", "4", "-t", "0", "--platform",
                         "cpu", "--dtype", "float64", "--blocked-bm", "8",
                         "-o", model]) == 0
    return item, train, va, model


def test_cli_skew_rows_match_jax(skew_set, tmp_path, capsys):
    """A skewed FFM through ``python -m one_class_ffm_torch`` (the v side's
    head tier, its fused field's table-space head terms): the same header,
    log rows and top-K ids as the JAX CLI, which took the head tier too."""
    from one_class_ffm_tpu import cli as jax_cli
    from one_class_ffm_tpu import train as jax_train
    from one_class_ffm_torch import cli as torch_cli
    from one_class_ffm_torch.train import TrainConfig, Trainer
    from test_torch_e2e import _run

    extra = ("--blocked-bm", "8")
    ref_out, ref_js = _run(jax_cli.main, skew_set, tmp_path, capsys, "jax",
                           extra=extra)
    got_out, got_js = _run(torch_cli.main, skew_set, tmp_path, capsys,
                           "torch", extra=extra)
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)
    item, train, _, _ = skew_set
    trainer = Trainer(TrainConfig(item_path=item, train_path=train, k=4,
                                  blocked_bm=8, dtype="float64"),
                      device="cpu")
    assert trainer.solver.hd_v and not trainer.solver.hd_u
    assert any(x is not None for x in trainer.solver.data["xh_v"])
    cfg = jax_train.TrainConfig(item_path=item, train_path=train,
                                blocked_bm=8)
    d = jax_train.load_problem(cfg)
    _, data = jax_solver.make_device_data(
        d.u_pad, d.v_pad, d.y_pad, d.layout, cfg.hyper(),
        dtype=jnp.float64, blocked_bm=8)
    assert "blk_v_hd_row" in data and "blk_u_hd_row" not in data


def test_trainer_resume_rebuilds_the_head_carry(skew_set, tmp_path):
    """A skewed run resumed from its npz checkpoint (the format is
    unchanged: tables only; ``refresh_caches`` rebuilds the carry, head
    slots included) ends where the straight run ends."""
    from one_class_ffm_torch.train import TrainConfig, Trainer

    item, train, va, model = skew_set
    base = dict(item_path=item, train_path=train, test_path=va, k=4,
                dtype="float64", init_model=model, eval_every=2,
                eval_chunk=16, blocked_bm=8)
    straight = Trainer(TrainConfig(nr_pass=4, **base), device="cpu")
    assert straight.solver.hd_v
    straight.run(log=lambda *_: None)
    ck = str(tmp_path / "ck")
    Trainer(TrainConfig(nr_pass=2, ckpt_dir=ck, **base),
            device="cpu").run(log=lambda *_: None)
    resumed = Trainer(TrainConfig(nr_pass=4, ckpt_dir=ck, resume=True,
                                  **base), device="cpu")
    resumed.run(log=lambda *_: None)
    assert resumed.epoch_idx == 4
    ref = straight.params_numpy()
    for f12, blk in resumed.params_numpy().items():
        for name in ("W", "H"):
            np.testing.assert_allclose(blk[name], ref[f12][name],
                                       rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(resumed.state["yt_v_hd"].numpy(),
                               straight.state["yt_v_hd"].numpy(),
                               rtol=1e-10, atol=1e-12)
