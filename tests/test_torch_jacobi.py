"""Jacobi-preconditioned CG (``cg_precond="jacobi"``) in the port.

The three gradient passes that carry the Hessian diagonal's second output
(the blocked scatter's ``w_blk`` payload, the fused cross gradient's
``w_blk`` output, the fused self gradient's ``dd`` output) against the JAX
package's Pallas kernels in interpret mode; the solver's diagonal on every
block side against the fp64 oracle's ``diag_hessian``; two Jacobi epochs
against the oracle and against the JAX solver (its k-major and fused table
kernels in interpret mode, equal CG counts per solve); and the command line
against the JAX one.  Inputs are made with numpy from a seed and go through
both sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_tpu import cli as jax_cli
from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_tpu.solver import oracle
from one_class_ffm_torch import cli as torch_cli
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops
from one_class_ffm_torch.ops.layout import (
    FeatureMajor,
    feature_major,
    make_blocked_layout,
    row_runs,
)
from one_class_ffm_torch.solver import torch_solver
from test_torch_e2e import _run, ffm_set, fm_set, mf_set  # noqa: F401
from test_torch_solver import build_jax, build_port, ffm_problem, mf_problem
from test_torch_wide import CAP, wide_problem

torch.set_num_threads(1)

# max-rel (scripts/kt_debug.py's measure).  float64: the two sides sum in
# other orders.  bfloat16: one bf16 ulp of the largest output (2^-7), not
# kt_debug's 5e-3: the storage-dtype payloads round at other points on the
# two sides (XLA's CPU backend may keep a bf16 elementwise chain at float32
# and round once, and sums in another order), so an output or a payload
# element lands one ulp apart, and at these toy shapes the largest output
# can sit just above a power of two, where one ulp is 2^-7 of it
RTOL = {torch.float64: 1e-9, torch.bfloat16: 2.0 ** -7}


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def J(a, dtype):
    """numpy -> JAX at the port's storage dtype (bf16 values are exactly
    the port's)."""
    if dtype == torch.bfloat16:
        return jnp.asarray(T(a, dtype).float().numpy(), jnp.bfloat16)
    return jnp.asarray(a)


def _max_rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got.double().numpy() - ref).max() / np.abs(ref).max())


@pytest.fixture
def stream():
    """A blocked stream (unsorted segments, as the v side's) at toy size."""
    rng = np.random.default_rng(7)
    num, n_other, nnz, k, BM = 32, 20, 150, 5, 8
    seg = rng.integers(0, num, size=nnz).astype(np.int32)
    take = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(seg, take, num, BM, max_pad_ratio=50.0)
    rows = rng.normal(size=(n_other, k))[blk["take"]]
    own = blk["own"]
    return dict(rng=rng, num=num, k=k, BM=BM, own=own, rows=rows,
                w=rng.random(own.shape) * (own < BM),
                c=rng.normal(size=own.shape) * (own < BM))


def _field(rng, num, d, p=3):
    """A padded feature field: duplicate ids in some rows, pad slots and
    two pad rows at the end."""
    idx = rng.integers(0, d, size=(num, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(num, p))
    idx[::5, 2] = idx[::5, 1]
    pad = rng.random((num, p)) < 0.25
    pad[:, 0] = False
    idx[pad], val[pad] = 0, 0.0
    idx[-2:], val[-2:] = 0, 0.0
    return idx, val


def _xt(idx, val, d, dtype):
    fm = feature_major(idx, val, d)
    v = T(fm.val, dtype)
    return FeatureMajor(row=T(fm.row), val=v, chunk_ptr=T(fm.chunk_ptr),
                        feat_ptr=T(fm.feat_ptr), n_rows=fm.n_rows,
                        val_sq=v * v)


# ---------------------------------------------------------------------------
# the three diagonal outputs against the TPU kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_scatter_diag_matches_pos_scatter_kt_pallas(stream, dtype):
    f, num, BM = stream, stream["num"], stream["BM"]
    scale = 0.9
    kernels.reset_launch_counts()
    zpos, posq = tops.pos_scatter_blocked(
        T(f["c"], dtype), T(f["rows"], dtype), T(f["own"]), num, BM,
        w_blk=T(f["w"], dtype), wq_scale=scale)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain version
    rows_t = np.transpose(f["rows"], (0, 2, 1))
    jz, jq = jops.pos_scatter_kt_pallas(
        J(f["c"], dtype), J(rows_t, dtype), jnp.asarray(f["own"]), num, BM,
        w_blk=J(f["w"], dtype), wq_scale=scale, interpret=True)
    for got, ref in ((zpos, jz), (posq, jq)):
        assert got.dtype == dtype and got.shape == (num, f["k"])
        assert _max_rel(got, ref) <= RTOL[dtype]
    # the gradient output is the pass without the diagonal, bit for bit
    assert torch.equal(zpos, tops.pos_scatter_blocked(
        T(f["c"], dtype), T(f["rows"], dtype), T(f["own"]), num, BM))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_grad_cross_diag_matches_grad_cross_tbl_pallas(stream, dtype):
    f, num, k, BM = stream, stream["num"], stream["k"], stream["BM"]
    rng, d, scale = f["rng"], 13, 0.9
    idx, val = _field(rng, num, d)
    dense = rng.normal(size=(num, k))
    xt = _xt(idx, val, d, dtype)
    # with the static row runs the kernel reads (the CPU ignores them)
    Gt, Qt = tops.grad_cross_tbl(xt, T(f["rows"], dtype), T(f["own"]),
                                 T(f["c"], dtype), T(dense, dtype), BM,
                                 w_blk=T(f["w"], dtype), wq_scale=scale,
                                 runs=T(row_runs(f["own"], BM)))
    it, vt = jnp.asarray(idx.T), J(val.T, dtype)
    args = (J(f["rows"], dtype), jnp.asarray(f["own"]), J(f["c"], dtype),
            J(dense, dtype), BM)
    refs = [jops.grad_cross_tbl_pallas(
        d, it, vt, *args, w_blk=J(f["w"], dtype), wq_scale=scale,
        interpret=True)]
    rows_t = np.transpose(f["rows"], (0, 2, 1))
    refs.append(jops.grad_cross_tbl_kt_pallas(
        d, it, vt, J(rows_t, dtype), *args[1:], w_blk=J(f["w"], dtype),
        wq_scale=scale, interpret=True))
    acc = torch.promote_types(dtype, torch.float32)
    for jg, jq in refs:
        for got, ref in ((Gt, jg), (Qt, jq)):
            # table-space outputs stay at the float32 floor, unrounded
            assert got.dtype == acc and got.shape == (d, k)
            assert _max_rel(got, ref) <= RTOL[dtype]
    assert torch.equal(Gt, tops.grad_cross_tbl(
        xt, T(f["rows"], dtype), T(f["own"]), T(f["c"], dtype),
        T(dense, dtype), BM))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_grad_self_diag_matches_grad_self_tbl_pallas(stream, dtype):
    f, num, k, BM = stream, stream["num"], stream["k"], stream["BM"]
    rng, d = f["rng"], 11
    idx, val = _field(rng, num, d)
    Q1 = rng.normal(size=(num, k))
    zdense = rng.normal(size=num)
    dd = rng.uniform(1.0, 5.0, size=num)
    xt = _xt(idx, val, d, dtype)
    Gt, Dq = tops.grad_self_tbl(xt, T(Q1, dtype), T(zdense, dtype),
                                T(f["own"]), T(f["c"], dtype), BM,
                                dd=T(dd, dtype))
    it, vt = jnp.asarray(idx.T), J(val.T, dtype)
    own, c = jnp.asarray(f["own"]), J(f["c"], dtype)
    refs = (jops.grad_self_tbl_pallas(d, it, vt, J(Q1, dtype),
                                      J(zdense[:, None], dtype), own, c, BM,
                                      dd=J(dd[:, None], dtype),
                                      interpret=True),
            jops.grad_self_tbl_kt_pallas(d, it, vt, J(Q1, dtype),
                                         J(zdense[None, :], dtype), own, c,
                                         BM, dd_row=J(dd[None, :], dtype),
                                         interpret=True))
    for jg, jq in refs:
        for got, ref in ((Gt, jg), (Dq, jq)):
            assert got.shape == (d, k)
            assert _max_rel(got, ref) <= RTOL[dtype]


def test_squared_scatter_matches_scatter_xla_of_squares():
    """The wide field's (X^2)^T Z (_scat_sq) against the JAX package's
    ``scatter(idx, val * val, Z, d)``."""
    rng = np.random.default_rng(3)
    rows, d, k = 60, 4500, 4
    idx, val = _field(rng, rows, d)
    Z = rng.normal(size=(rows, k))
    got = tops.scatter(_xt(idx, val, d, torch.float64), T(Z), squared=True)
    ref = jops.scatter_xla(jnp.asarray(idx), jnp.asarray(val * val),
                           jnp.asarray(Z), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)
    with pytest.raises(ValueError, match="val_sq"):
        tops.scatter(_xt(idx, val, d, torch.float64)._replace(val_sq=None),
                     T(Z), squared=True)


# ---------------------------------------------------------------------------
# the solver under Jacobi
# ---------------------------------------------------------------------------

CASES = ("mf", "mf_self", "ffm_self", "ffm_ns", "ffm_freq", "fm",
         "wide_fm_self", "wide_ffm_mixed")


def jacobi_problem(case, seed=1):
    """The port's solver test problems with cg_precond="jacobi": MF (the
    --ns identity fields), the FFM family (identity and fused fields, self
    blocks, freq-lambda, a mixed FM field below the fused cap) and, under
    the lowered cap of tests/test_torch_wide.py, FM with wide fields and an
    FFM with identity, fused and wide fields."""
    if case == "mf":
        prob, params = mf_problem(seed=seed)
    elif case.startswith("wide_"):
        prob, params = wide_problem(case[5:], seed=seed)
    else:
        prob, params = ffm_problem(case, seed=seed)
    return (dataclasses.replace(
        prob, hp=dataclasses.replace(prob.hp, cg_precond="jacobi")), params)


@pytest.fixture
def cap_for(monkeypatch):
    """Lower the fused-table cap on both sides for the wide cases."""
    def apply(case):
        if case.startswith("wide_"):
            monkeypatch.setattr(torch_solver, "FUSED_TBL_D", CAP)
            monkeypatch.setenv("OCFFM_FUSED_TBL_D", str(CAP))
    return apply


def _kinds(solver, prob):
    out = set()
    for b in prob.layout.all_blocks():
        for first in (True, False):
            xf = solver._x(b, first)[2]
            out.add((b.kind, "ident" if xf is None else
                     "fused" if solver._fused(b, first) else "wide"))
    return out


@pytest.mark.parametrize("case", CASES)
def test_diag_matches_oracle(case, cap_for):
    """The Jacobi diagonal of every block side (the gradient pass's second
    output, scattered through X^2) against ``oracle.diag_hessian``."""
    cap_for(case)
    prob, params = jacobi_problem(case)
    solver, state = build_port(prob, params)
    kinds = _kinds(solver, prob)
    if case == "wide_ffm_mixed":
        assert {k for _, k in kinds} == {"ident", "fused", "wide"}
    sa, sb = solver.sasb(state)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G, _, _, _, D = solver.solve_inputs(state, b, first, sa, sb)
            D_ref = oracle.diag_hessian(prob, params, b, first)
            assert D.shape == D_ref.shape
            np.testing.assert_allclose(D.numpy(), D_ref, rtol=1e-8,
                                       atol=1e-10, err_msg=f"{b.f12} {first}")
            G_ref, _ = oracle.grad_and_hv(prob, params, b, first)
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-8,
                                       atol=1e-10)


@pytest.mark.parametrize("case", CASES)
def test_two_jacobi_epochs_match_oracle(case, cap_for):
    cap_for(case)
    prob, params = jacobi_problem(case)
    solver, state = build_port(prob, params)
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


@pytest.mark.parametrize("case", ["mf", "ffm_self", "fm", "wide_fm_self",
                                  "wide_ffm_mixed"])
def test_jacobi_epochs_match_jax(case, cap_for, monkeypatch):
    """Against the JAX solver under Jacobi, its k-major and fused table
    kernels in interpret mode: equal CG iteration counts per solve, and
    matching tables (float64, sums in other orders)."""
    cap_for(case)
    prob, params = jacobi_problem(case, seed=4)
    tsolver, tst = build_port(prob, params)
    jsolver, jst = build_jax(prob, params, monkeypatch)
    assert tsolver.cg_precond == jsolver.cg_precond == "jacobi"
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


def test_jacobi_changes_the_search_not_the_stop_rule():
    """Jacobi and plain CG solve the same system to the same true-residual
    rule: the first solve's gradient is the same, the steps differ."""
    prob, params = ffm_problem("ffm_self", seed=2)
    plain, pst = build_port(prob, params)
    jprob, _ = jacobi_problem("ffm_self", seed=2)
    jac, jst = build_port(jprob, params)
    assert plain.cg_precond == "none" and jac.cg_precond == "jacobi"
    b = prob.layout.epoch_order()[0]
    sa, sb = plain.sasb(pst)
    Gp, _, _, _, Dp = plain.solve_inputs(pst, b, True, sa, sb)
    Gj, _, _, _, Dj = jac.solve_inputs(jst, b, True, sa, sb)
    assert Dp is None and torch.all(Dj > 0)
    assert torch.equal(Gp, Gj)
    sp, _ = plain._solve_half(pst, b, True, sa, sb)
    sj, _ = jac._solve_half(jst, b, True, sa, sb)
    assert not torch.equal(sp["params"][b.f12]["W"], sj["params"][b.f12]["W"])


def test_device_data_carries_colsq_and_squared_lists():
    """colsq for the fused fields only, as the JAX dict holds it; X^2 beside
    X in every non-identity field's feature-major list."""
    from test_torch_solver import padded
    from one_class_ffm_tpu.solver import jax_solver

    prob, _ = ffm_problem("ffm_self")
    u, v, y = padded(prob)
    _, jd = jax_solver.make_device_data(u, v, y, prob.layout, prob.hp,
                                        dtype=jnp.float64, blocked_bm=4)
    meta, td = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=4,
        device="cpu")
    for s in ("u", "v"):
        for got, ref, xf in zip(td[f"colsq_{s}"], jd[f"colsq_{s}"],
                                td[f"xf_{s}"]):
            assert (got is None) == (ref is None)
            if got is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            if xf is not None:
                assert torch.equal(xf.val_sq, xf.val * xf.val)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

JACOBI = ("--cg-precond", "jacobi")


@pytest.mark.parametrize("data", ["mf", "ffm"])
def test_jacobi_cli_rows_match_jax(data, mf_set, ffm_set,  # noqa: F811
                                   tmp_path, capsys):
    """MF --ns and FFM with self blocks under --cg-precond jacobi: the same
    header, log rows and top-K ids as the JAX CLI, byte for byte."""
    data_set = mf_set if data == "mf" else ffm_set
    extra = (("--ns",) if data == "mf" else ()) + JACOBI
    ref_out, ref_js = _run(jax_cli.main, data_set, tmp_path, capsys, "jax",
                           extra=extra)
    got_out, got_js = _run(torch_cli.main, data_set, tmp_path, capsys,
                           "torch", extra=extra)
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)


def test_jacobi_cli_fm_rows_match_jax(fm_set, tmp_path, capsys,  # noqa: F811
                                      monkeypatch):
    """FM with self blocks, both fields above a lowered fused-table cap (the
    squared X^T lists of wide fields), under --cg-precond jacobi."""
    monkeypatch.setattr(torch_solver, "FUSED_TBL_D", 8)
    monkeypatch.setenv("OCFFM_FUSED_TBL_D", "8")
    item, train, va, models = fm_set
    data_set = (item, train, va, models["self"])
    ref_out, _ = _run(jax_cli.main, data_set, tmp_path, capsys, "jax",
                      extra=JACOBI)
    got_out, _ = _run(torch_cli.main, data_set, tmp_path, capsys, "torch",
                      extra=JACOBI)
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3


# ---------------------------------------------------------------------------
# chip_smoke's Jacobi phases, rehearsed at toy size on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_smoke_jacobi_rehearsal_on_cpu():
    """Its Jacobi FFM cases name the blocks whose gradient passes carry the
    three diagonal outputs, its reference data has no repeated ids, the
    work of each diagonal variant counts both outputs, and its FFM main
    path trains under Jacobi."""
    chip_smoke = _chip_smoke()
    data = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True)
    clean = chip_smoke._without_repeated_ids(data)
    for pf, before in ((clean.u_pad, data.u_pad), (clean.v_pad, data.v_pad)):
        for idx, val, val0 in zip(pf.idx, pf.val, before.val):
            for row, v in zip(idx, val):
                live = row[v != 0]
                assert len(set(live.tolist())) == len(live)
            assert np.all((val == val0) | (val == 0))
    assert any(np.any(a != b) for a, b in zip(clean.u_pad.val,
                                              data.u_pad.val))
    trainer = chip_smoke.make_trainer(data, "cpu", k=4, epochs=2,
                                      cg_precond="jacobi")
    solver = trainer.solver
    assert solver.cg_precond == "jacobi"
    cases = chip_smoke.jacobi_cases(trainer)
    assert {n for case in cases for n in case[0]} == set(chip_smoke.DIAG)
    state = trainer.init_state()
    sa, sb = solver.sasb(state)
    for names, b, first, _ in cases:
        fused = solver._fused(b, first)
        assert fused == (names[0] != "pos_scatter_blocked_diag")
        _, _, _, _, D = solver.solve_inputs(state, b, first, sa, sb)
        assert D is not None and torch.all(D > 0)
    # the work of the variants: two outputs, the X^2 list read as well
    xt = solver.data["xf_u"][1]
    pre = "blk_u_"
    rows = torch.rand(solver.data[pre + "own"].shape + (4,))
    args = (xt, rows, solver.data[pre + "own"],
            torch.rand(rows.shape[:2]), torch.rand(xt.n_rows, 4), 256,
            torch.rand(rows.shape[:2]), 0.9)
    out = (torch.empty(xt.feat_ptr.numel() - 1, 4),) * 2
    nb_diag, ops_diag = chip_smoke.work("grad_cross_tbl_diag", args, out)
    nb_one, ops_one = chip_smoke.work("grad_cross_tbl", args[:6], out[0])
    assert nb_diag > nb_one and ops_diag > ops_one
    assert chip_smoke.library_call("grad_cross_tbl_diag", args) is None
    res = chip_smoke.train_and_validate(trainer, epochs=2)
    chip_smoke.check_main_path(res)
    assert all(len(i) == 2 * len(solver.blocks) for i in res["iters"])


def test_chip_smoke_reads_register_counts(monkeypatch):
    """The build phase's registers per thread, static shared memory and
    stack per thread, parsed from cuobjdump's resource report (mangled
    names: kernel, storage type, Jacobi flag and the integer template
    arguments of a width plan, (G, NV, VE)); a report without SHARED counts
    0 bytes."""
    chip_smoke = _chip_smoke()
    report = "\n".join([
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d18pos_"
        "scatter_kernelI13__nv_bfloat16Lb1EEEvPKT_S4_PKiS4_fPS2_S7_iii:",
        "REG:40 STACK:0 SHARED:0",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678219xt_feature"
        "_kernelEPKfPKiiPfi:",
        "REG:30 STACK:0",
        "Function _ZN47_GLOBAL__N__d215_14_hv_variants_cu_8938cdc220pos_hv_"
        "packed_kernelIfEEvPKT_S3_PKiS3_S3_PS1_iif:",
        "REG:32 STACK:0",
        # a width plan's integer arguments, with and without a storage type
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d18pos_"
        "scatter_kernelI13__nv_bfloat16Li4ELi1ELi8ELb1EEvPKT_S4_PKiS4_fPS2_"
        "S7_iiii:",
        "REG:56 STACK:0 SHARED:32",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678215xt_chunk_"
        "kernelIfLi8ELi1ELi4EEvPKT_PKiS3_S5_S5_iPfS6_i:",
        "REG:48 STACK:0",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678217xt_combine"
        "_kernelILi32ELi8ELi1EEvPKfPKiS3_S3_iPfi:",
        "REG:38 STACK:0",
        # the blocked Hv on its width plans (B1, B4's row stage)
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d13pos_hv_"
        "kernelIfLi8ELi1ELi4EEEvPKT_S4_PKiS4_S4_PS2_iiifi:",
        "REG:64 STACK:0 SHARED:16",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678218hv_tbl_rows"
        "_kernelI13__nv_bfloat16Li4ELi1ELi8EEEvPKT_PKiS4_iiS4_S6_S4_S4_PS2_"
        "iiifi:",
        "REG:72 STACK:0 SHARED:16",
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d13pos_hv_"
        "kernelIfLi32ELi8ELi1EEEvPKT_S4_PKiS4_S4_PS2_iiifi:",
        "REG:56 STACK:0 SHARED:16",
        # the group-per-row projection (B8, B6's row stage) and B6's X^T
        # stage over Q1 and s
        "Function _ZN49_GLOBAL__N__1f2e_14_project_ops_cu_a1b2c3d419project_"
        "rows_kernelIfLi8ELi1ELi4EEEvN5ocffm12ProjectedPhiIT_EENS_8StoreRow"
        "IS3_EEl:",
        "REG:40 STACK:0 SHARED:0",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678220hv_self_"
        "scale_kernelI13__nv_bfloat16Li32ELi8ELi1EEEvN5ocffm12ProjectedPhi"
        "IT_EENS_9SelfScaleIS4_EEl:",
        "REG:64 STACK:0",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678216xt_scaled_"
        "kernelIfLi8ELi1ELi4EEEvPKT_S4_PKiS4_S6_S6_iS6_S6_iS6_PiPfS8_i:",
        "REG:80 STACK:0 SHARED:0"])

    class Done:
        stdout = report

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done)
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda p: True)
    assert chip_smoke.kernel_registers("lib.so") == {
        ("pos_scatter_kernel", "bf16", True, ()): (40, 0, 0),
        ("pos_hv_packed_kernel", "f32", False, ()): (32, 0, 0),
        ("pos_scatter_kernel", "bf16", True, (4, 1, 8)): (56, 32, 0),
        ("xt_chunk_kernel", "f32", False, (8, 1, 4)): (48, 0, 0),
        ("xt_combine_kernel", "f32", False, (32, 8, 1)): (38, 0, 0),
        ("pos_hv_kernel", "f32", False, (8, 1, 4)): (64, 16, 0),
        ("hv_tbl_rows_kernel", "bf16", False, (4, 1, 8)): (72, 16, 0),
        ("pos_hv_kernel", "f32", False, (32, 8, 1)): (56, 16, 0),
        ("project_rows_kernel", "f32", False, (8, 1, 4)): (40, 0, 0),
        ("hv_self_scale_kernel", "bf16", False, (32, 8, 1)): (64, 0, 0),
        ("xt_scaled_kernel", "f32", False, (8, 1, 4)): (80, 0, 0)}


def test_chip_smoke_work_counts_the_runs_in_place_of_the_owners():
    """B1's and B4's bounds, given the static row runs, count the runs'
    bytes in place of the owners' (own is B4's sixth argument, not its
    third), and the operations do not change."""
    from one_class_ffm_torch.ops.layout import (
        FeatureMajor,
        feature_major,
        row_runs,
    )

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(12)
    nb, maxc, bm, k, d, p = 3, 40, 8, 4, 11, 3
    own = np.sort(rng.integers(0, bm + 1, size=(nb, maxc)), axis=1)
    own_t = torch.as_tensor(own, dtype=torch.int32)
    runs = torch.as_tensor(row_runs(own, bm))
    rows = torch.rand(nb, maxc, k)
    w = torch.rand(nb, maxc) * (own_t < bm)
    dense = torch.rand(k, k)
    idx = rng.integers(0, d, size=(nb * bm, p)).astype(np.int32)
    val = rng.random((nb * bm, p)).astype(np.float32)
    fm = feature_major(idx, val, d)
    xt = FeatureMajor(*(torch.as_tensor(a) for a in (
        fm.row, fm.val, fm.chunk_ptr, fm.feat_ptr)), n_rows=fm.n_rows)
    tbl = (torch.rand(d, k), torch.as_tensor(idx), torch.as_tensor(val), xt,
           rows, own_t, w, dense, bm, 0.9)
    blk = (torch.rand(nb * bm, k), rows, own_t, w, dense, nb * bm, bm, 0.9)
    for name, args, out in (("pos_hv_tbl", tbl, torch.empty(d, k)),
                            ("pos_hv_blocked", blk,
                             torch.empty(nb * bm, k))):
        nbytes, ops = chip_smoke.work(name, args, out)
        nbytes_r, ops_r = chip_smoke.work(name, args, out, {"runs": runs})
        assert ops_r == ops and ops > 0, name
        assert nbytes_r - nbytes == 4 * nb * (bm + 1 - maxc), name


def test_chip_smoke_work_counts_b9s_runs_in_place_of_its_owners_once():
    """B9's bound, given the static row runs, counts the packed rows, the
    runs, one lane of each 32-lane weight group, phi, dense and the output:
    the runs replace the packed owners once (without them, one lane of each
    owner group); the operations do not change.  Its sector floor counts a
    32-byte sector per slot for the weight."""
    from one_class_ffm_torch.ops.layout import row_runs

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(15)
    nb, maxc, bm, k = 3, 40, 8, 32
    own = np.sort(rng.integers(0, bm + 1, size=(nb, maxc)), axis=1)
    own_t = torch.as_tensor(own, dtype=torch.int32)
    runs = torch.as_tensor(row_runs(own, bm))
    rows_p, own_p, w_p = tops.pack_rows(torch.rand(nb, maxc, k), own_t,
                                        torch.rand(nb, maxc) * (own_t < bm))
    phi, dense = torch.rand(nb * bm, k), torch.rand(k, k)
    args = (phi, rows_p, own_p, w_p, dense, nb * bm, bm, 0.9)
    out = torch.empty(nb * bm, k)
    nbytes_r, ops_r = chip_smoke.work("pos_hv_packed", args, out,
                                      {"runs": runs})
    nbytes, ops = chip_smoke.work("pos_hv_packed", args, out)
    size = {name: t.numel() * t.element_size() for name, t in (
        ("rows_p", rows_p), ("own_p", own_p), ("w_p", w_p), ("phi", phi),
        ("dense", dense), ("out", out), ("runs", runs))}
    rest = size["rows_p"] + size["w_p"] // 32 + size["phi"] + size["dense"] \
        + size["out"]
    assert nbytes_r == rest + size["runs"]
    assert nbytes == rest + size["own_p"] // 32
    assert ops_r == ops and ops > 0
    assert chip_smoke.sector_floor_bytes(args, nbytes_r) == \
        nbytes_r + nb * maxc * (32 - 4)


def test_chip_smoke_work_counts_the_runs_of_b3_and_b7():
    """B3's and B7's bounds (B7 with and without its Jacobi output), given
    the static row runs, count the runs' bytes in place of the owners' (own
    is B3's third argument and B7's fourth), and the operations do not
    change."""
    from one_class_ffm_torch.ops.layout import (
        FeatureMajor,
        feature_major,
        row_runs,
    )

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(13)
    nb, maxc, bm, k, d, p = 3, 40, 8, 4, 11, 3
    own = np.sort(rng.integers(0, bm + 1, size=(nb, maxc)), axis=1)
    own_t = torch.as_tensor(own, dtype=torch.int32)
    runs = torch.as_tensor(row_runs(own, bm))
    idx = rng.integers(0, d, size=(nb * bm, p)).astype(np.int32)
    val = rng.random((nb * bm, p)).astype(np.float32)
    fm = feature_major(idx, val, d)
    xt = FeatureMajor(*(torch.as_tensor(a) for a in (
        fm.row, fm.val, fm.chunk_ptr, fm.feat_ptr)), n_rows=fm.n_rows)
    xt = xt._replace(val_sq=xt.val * xt.val)
    c = torch.rand(nb, maxc) * (own_t < bm)
    b7 = (xt, torch.rand(nb * bm, k), torch.rand(nb * bm), own_t, c, bm)
    cases = (
        ("pos_gap_blocked", (torch.rand(nb * bm, k), torch.rand(nb, maxc, k),
                             own_t, bm), torch.empty(nb * maxc)),
        ("grad_self_tbl", b7, torch.empty(d, k)),
        ("grad_self_tbl_diag", b7 + (torch.rand(nb * bm),),
         (torch.empty(d, k), torch.empty(d, k))))
    for name, args, out in cases:
        nbytes, ops = chip_smoke.work(name, args, out)
        nbytes_r, ops_r = chip_smoke.work(name, args, out, {"runs": runs})
        assert ops_r == ops and ops > 0, name
        assert nbytes_r - nbytes == 4 * nb * (bm + 1 - maxc), name


def test_chip_smoke_reads_the_stack_of_b3_and_b7s_kernels(monkeypatch):
    """The build phase reads the staged gap (B3, on B1's plans), its
    warp-per-slot path, B7's row stage and the X^T stage's third source,
    with the bytes of stack a spill would take."""
    chip_smoke = _chip_smoke()
    report = "\n".join([
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d15gap_rows"
        "_kernelIfLi8ELi1ELi4EEEvPKT_S3_PKiPS1_iiii:",
        "REG:40 STACK:0 SHARED:1152 LOCAL:0 CONSTANT[0]:576",
        "Function _ZN47_GLOBAL__N__c7f4_14_blocked_ops_cu_e3a6494d16gap_"
        "slots_kernelI13__nv_bfloat16EEvPKT_S4_PKiPS2_liii:",
        "REG:32 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:580",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678222grad_self"
        "_scale_kernelIfEEvPKT_PKiS3_PS1_lii:",
        "REG:32 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:576",
        "Function _ZN45_GLOBAL__N__6a7b_12_table_ops_cu_257c678219xt_scaled"
        "_sq_kernelI13__nv_bfloat16Li4ELi1ELi8EEEvPKT_S5_PKiS5_S7_S7_iS7_S7_"
        "iS7_PiPfS9_i:",
        "REG:80 STACK:24 SHARED:1024 LOCAL:0 CONSTANT[0]:644"])

    class Done:
        stdout = report

    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done)
    monkeypatch.setattr(chip_smoke.os.path, "exists", lambda p: True)
    assert chip_smoke.kernel_registers("lib.so") == {
        ("gap_rows_kernel", "f32", False, (8, 1, 4)): (40, 1152, 0),
        ("gap_slots_kernel", "bf16", False, ()): (32, 1024, 0),
        ("grad_self_scale_kernel", "f32", False, ()): (32, 1024, 0),
        ("xt_scaled_sq_kernel", "bf16", False, (4, 1, 8)): (80, 1024, 24)}


def test_chip_smoke_work_counts_the_runs_of_b5_and_b10():
    """B5's bounds (with and without its Jacobi output) and B10's, given
    the static row runs, count the runs' bytes in place of the owners' (own
    is the third argument of both), and the operations do not change; B5's
    and its Jacobi variant's [kernels] lines give their X^T stage alone."""
    from one_class_ffm_torch.ops.layout import (
        FeatureMajor,
        feature_major,
        row_runs,
    )

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(14)
    nb, maxc, bm, k, d, p = 4, 40, 8, 4, 11, 3
    own = np.sort(rng.integers(0, bm + 1, size=(nb, maxc)), axis=1)
    own_t = torch.as_tensor(own, dtype=torch.int32)
    runs = torch.as_tensor(row_runs(own, bm))
    idx = rng.integers(0, d, size=(nb * bm, p)).astype(np.int32)
    val = rng.random((nb * bm, p)).astype(np.float32)
    fm = feature_major(idx, val, d)
    xt = FeatureMajor(*(torch.as_tensor(a) for a in (
        fm.row, fm.val, fm.chunk_ptr, fm.feat_ptr)), n_rows=fm.n_rows)
    xt = xt._replace(val_sq=xt.val * xt.val)
    rows = torch.rand(nb, maxc, k)
    valid = own_t < bm
    b5 = (xt, rows, own_t, torch.rand(nb, maxc) * valid,
          torch.rand(nb * bm, k), bm)
    b10 = (torch.rand(nb * bm, k), rows, own_t, torch.rand(nb, maxc) * valid,
           torch.rand(k, k), nb * bm, bm, 2, 0.9)
    cases = (
        ("grad_cross_tbl", b5, torch.empty(d, k)),
        ("grad_cross_tbl_diag", b5 + (torch.rand(nb, maxc) * valid, 0.9),
         (torch.empty(d, k), torch.empty(d, k))),
        ("pos_hv_blocked_g", b10, torch.empty(nb * bm, k)))
    for name, args, out in cases:
        nbytes, ops = chip_smoke.work(name, args, out)
        nbytes_r, ops_r = chip_smoke.work(name, args, out, {"runs": runs})
        assert ops_r == ops and ops > 0, name
        assert nbytes_r - nbytes == 4 * nb * (bm + 1 - maxc), name
    assert {"grad_cross_tbl", "grad_cross_tbl_diag"} <= set(
        chip_smoke.XT_STAGED)
