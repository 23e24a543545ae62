"""The CG solve's device loop: the recurrence kernel's plain version
(``sparse_ops.cg_step_plain``) in the grouped loop with the stop rule
beside the scalars, against the loop with a host test before every
iteration, the JAX package's ``FFMSolver._cg`` and its epochs.

On one process ``FFMSolver._cg_loop`` runs ``cg_group`` iterations per host
read of the stop flag; the iterations after the stop write nothing, so S
and the count are those of the host loop bit for bit, at every group size,
plain CG and Jacobi, float64, float32 and bfloat16 storage, a solve that
converges, one at the cap and one stopped by the ``den > 0`` guard.  On the
card the same loop runs as CUDA graph replays of the recurrence kernel,
held there by tests/test_torch_cuda.py and chip_smoke.  Inputs are made
with numpy from a seed; tolerances are stated where sums run in other
orders than the JAX package's."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_tpu.solver import jax_solver
from one_class_ffm_tpu.solver.params import HyperParams as JaxHyperParams
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as ops
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.params import HyperParams
from test_torch_solver import (
    build_jax,
    build_port,
    ffm_problem,
    mf_problem,
    padded,
)

torch.set_num_threads(1)

ROWS, K = 12, 3
DTYPES = [torch.float64, torch.float32, torch.bfloat16]
CAP = 20


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Bit patterns (torch.equal holds -0.0 equal to +0.0)."""
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(view[t.element_size()])


def _system(seed: int, case: str, storage, jacobi: bool):
    """(hv, G, D, cap, eps) of a (ROWS, K) table's Newton system: an SPD
    operator that converges in several iterations ("spd"), the same at a
    cap of 5 with a threshold it never meets ("cap"), or an Hv of zeros,
    which the den > 0 guard stops after one iteration ("guard")."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(ROWS, ROWS))
    A = torch.from_numpy(M @ M.T / ROWS + 0.5 * np.eye(ROWS))
    ct = torch.promote_types(storage, torch.float32)
    G = torch.from_numpy(rng.normal(size=(ROWS, K))).to(storage)
    D = None
    if jacobi:
        D = torch.from_numpy(np.diag(A.numpy())[:, None]
                             * rng.uniform(0.8, 1.2, size=(ROWS, K))).to(ct)

    def hv(V):
        if case == "guard":
            return torch.zeros_like(V)
        return (A @ V.double()).to(V.dtype)

    cap, eps = (5, 1e-30) if case == "cap" else (CAP, 1e-6)
    return hv, G, D, cap, eps


def _loop(hv, G, D, storage, cap, eps, group=1, host=False):
    """``FFMSolver._cg_loop`` on one process (no mesh), on the CPU."""
    ns = types.SimpleNamespace(
        meta=types.SimpleNamespace(
            hp=HyperParams(cg_eps=eps, cg_max_iter=cap), dtype=storage),
        mesh=None, cg_group=group, cg_host_loop=host,
        cg_counts=dict(reads=0, replays=0, masked=0),
        _graph_path=lambda: False)
    S, it = torch_solver.FFMSolver._cg_loop(ns, hv, G, D)
    return S, it, ns.cg_counts


@pytest.mark.parametrize("case", ["spd", "cap", "guard"])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("storage", DTYPES)
@pytest.mark.parametrize("group", [1, 3, "cap"])
def test_grouped_loop_is_the_host_loop_bit_for_bit(case, jacobi, storage,
                                                   group):
    hv, G, D, cap, eps = _system(7, case, storage, jacobi)
    g = cap if group == "cap" else group
    S_h, it_h, c_h = _loop(hv, G, D, storage, cap, eps, host=True)
    S_g, it_g, c_g = _loop(hv, G, D, storage, cap, eps, group=g)
    assert it_g == it_h
    assert torch.equal(_bits(S_g), _bits(S_h))
    assert S_g.dtype == torch.promote_types(storage, torch.float32)
    # one read per group, the iterations past the stop counted as masked
    reads = max(1, -(-it_h // g))
    assert c_g["reads"] == reads
    assert c_g["masked"] == reads * g - it_h
    assert c_h["reads"] == it_h + 1
    if case == "cap":
        assert it_h == cap
    elif case == "guard":
        assert it_h == 1 and not torch.any(S_h)
    else:
        assert 1 < it_h < cap


def test_a_stopped_step_writes_nothing():
    """An iteration entered after the stop keeps every vector and scalar."""
    hv, G, D, cap, eps = _system(3, "cap", torch.float32, True)
    st = ops.cg_init(G, D, torch.float32, eps, cap)
    while not ops.cg_read(st)[0]:
        ops.cg_step(st, hv(st.Vs))
    before = (st.S, st.R, st.V, st.Vs, ops.cg_scalars(st))
    ops.cg_step(st, hv(st.Vs))
    for a, b in zip(before[:4], (st.S, st.R, st.V, st.Vs)):
        assert a is b
    assert ops.cg_scalars(st) == before[4]


def test_cg_sum_plain_takes_the_kernels_order():
    """The kernels' order (torch's CUDA sum, Reduce.cuh, modelled by
    ``test_torch_cuda.reduce_model``): the launch shapes of
    ``kernels.cg_config`` for the H100 (single elements below 128, loads
    of 4 from 128, one CTA, several past 256 values a thread); the model
    against float64 at float32 rounding and its order on three terms; and
    the plain recurrence summing with torch's own sum, which the kernels
    reproduce on the card."""
    from test_torch_cuda import reduce_model

    rng = np.random.default_rng(0)
    for n, want in ((1, (False, 1, 1)), (39, (False, 32, 1)),
                    (127, (False, 64, 1)), (128, (True, 32, 1)),
                    (1027, (True, 256, 1)), (16000, (True, 512, 1)),
                    (640003, (True, 512, 79)), (6400000, (True, 512, 528))):
        cfg = kernels.cg_config(n)
        assert (cfg.vec, cfg.threads, cfg.ctas) == want, n
        x = torch.from_numpy(rng.normal(size=n)).float()
        got = reduce_model(x)
        assert got.dtype == torch.float32 and got.dim() == 0
        ref = x.double().sum().item()
        assert abs(got.item() - ref) <= 1e-5 * x.abs().sum().item()
    assert reduce_model(torch.arange(8, dtype=torch.float32)).item() == 28.0
    # 1e8 and 1 and -1e8 at float32: in threads 0, 1, 2 (one load of 4
    # each at n = 256) the warp's halving adds 1e8 - 1e8 first, then 1;
    # in the lanes of one load, ((1e8 + 1) - 1e8) loses the 1; a thread's
    # grid-strided loads add in order, (1e8 + 1) - 1e8 again
    span = 4 * kernels.cg_config(12288).threads  # one CTA, 6 loads each
    for n, pos, want in ((256, (0, 4, 8), 1.0), (256, (0, 1, 2), 0.0),
                         (12288, (0, span, 2 * span), 0.0)):
        x = torch.zeros(n)
        x[pos[0]], x[pos[1]], x[pos[2]] = 1e8, 1.0, -1e8
        assert reduce_model(x).item() == want, pos
    G = torch.from_numpy(rng.normal(size=(300, 7))).float()
    st = ops.cg_init_plain(G, None, torch.float32, 1e-6, 5)
    assert torch.equal(_bits(st.sc["g2"]), _bits((G * G).sum()))


def _jax_cg(hv_np, G, D, storage, cap, eps):
    """The JAX package's ``FFMSolver._cg`` on the same system."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[storage]
    ns = types.SimpleNamespace(meta=types.SimpleNamespace(
        hp=JaxHyperParams(cg_eps=eps, cg_max_iter=cap), dtype=jdt))
    S, it = jax_solver.FFMSolver._cg(
        ns, lambda V: hv_np(V), jnp.asarray(G.numpy()),
        None if D is None else jnp.asarray(D.numpy()))
    return np.asarray(S), int(it)


# rtol of S against the JAX package's CG: float64 sums in other orders
# (1e-16 a sum) through up to ROWS iterations; float32 the same at float32
RTOL = {torch.float64: 1e-12, torch.float32: 2e-5}


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("storage", [torch.float64, torch.float32])
def test_plain_loop_matches_jax_cg(jacobi, storage):
    hv, G, D, cap, eps = _system(11, "spd", storage, jacobi)
    A = hv(torch.eye(ROWS, dtype=torch.float64)).numpy()

    def hv_np(V):
        return (jnp.asarray(A) @ V.astype(jnp.float64)).astype(V.dtype)

    S, it, _ = _loop(hv, G, D, storage, cap, eps, group=3)
    S_j, it_j = _jax_cg(hv_np, G, D, storage, cap, eps)
    assert it == it_j and 1 < it < cap
    np.testing.assert_allclose(S.numpy(), S_j, rtol=RTOL[storage],
                               atol=RTOL[storage] * np.abs(S_j).max())


@pytest.mark.parametrize("case,precond", [("mf", "none"),
                                          ("ffm_self", "none"),
                                          ("ffm_self", "jacobi")])
def test_grouped_epochs_match_jax(case, precond, monkeypatch):
    """Two epochs of the grouped loop (3 iterations a read) against the
    JAX solver's: equal counts per solve, tables at rtol 1e-9 (float64,
    sums in other orders)."""
    prob, params = (mf_problem(seed=4) if case == "mf"
                    else ffm_problem(case, seed=4))
    prob = dataclasses.replace(
        prob, hp=dataclasses.replace(prob.hp, cg_precond=precond))
    tsolver, tst = build_port(prob, params)
    tsolver.cg_group = 3
    jsolver, jst = build_jax(prob, params, monkeypatch)
    for _ in range(2):
        tst, t_it = tsolver.epoch_stats(tst)
        jst, j_it = jsolver.epoch_stats(jst)
        np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
        assert t_it.sum() > 0
    assert tsolver.cg_counts["masked"] > 0
    for f12 in jst["params"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                tst["params"][f12][name].numpy(),
                np.asarray(jst["params"][f12][name]), rtol=1e-9, atol=1e-12,
                err_msg=f"{name} {f12}")


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [3, CAP])
def test_grouped_epoch_is_the_host_epoch_bit_for_bit(precond, dtype, group):
    """One FFM epoch (identity, fused and self blocks) from one state: the
    grouped loop's tables, caches, residuals and counts against the host
    loop's, bit for bit."""
    prob, params = ffm_problem("ffm_self", seed=2)
    prob = dataclasses.replace(
        prob, hp=dataclasses.replace(prob.hp, cg_precond=precond))
    solver, state = build_port(prob, params, dtype=dtype)
    solver.cg_host_loop = True
    host, it_h = solver.epoch_stats(state)
    reads_h = solver.cg_counts["reads"]
    solver.cg_host_loop, solver.cg_group = False, group
    grouped, it_g = solver.epoch_stats(state)
    assert torch.equal(it_g, it_h) and it_h.sum() > 0
    assert reads_h == int((it_h + 1).sum())
    assert solver.cg_counts["reads"] - reads_h == int(
        ((it_h + group - 1) // group).clamp(min=1).sum())
    for key in ("P", "Q", "params"):
        for f12, blk in host[key].items():
            pairs = blk.items() if key == "params" else [(None, blk)]
            for name, t in pairs:
                g = grouped[key][f12] if name is None \
                    else grouped[key][f12][name]
                assert torch.equal(_bits(g), _bits(t)), (key, f12, name)
    for key in ("a", "b", "yt_u", "yt_v"):
        assert torch.equal(_bits(grouped[key]), _bits(host[key])), key


def test_solver_defaults_and_argument():
    """The group defaults to CG_GROUP (1: one host read an iteration); no
    graphs exist off the card, so the CPU runs the eager loop."""
    prob, params = mf_problem()
    solver, _ = build_port(prob, params)
    assert torch_solver.CG_GROUP == 1
    assert solver.cg_group == 1 and solver._graphs is None
    assert not solver._graph_path() and not solver.cg_host_loop


def test_graph_path_takes_only_a_solver_closure():
    """The CUDA graph path replays a graph per closure key on the closure's
    input buffers: a closure without a key (not made by
    ``FFMSolver._hv_closure``) is refused before anything runs."""
    from one_class_ffm_torch.solver.cg_graph import CgGraphs

    G = torch.ones(4, 2)
    with pytest.raises(ValueError, match="_hv_closure"):
        CgGraphs(torch.device("cpu")).solve(lambda V: 2.0 * V, G, None,
                                            torch.float32, 1e-6, 5, 1)


def test_traced_loop_is_the_solver_loop():
    """mesh_accuracy's traced loop (one host test per iteration, each
    recorded) steps the solver's recurrence: the same S and counts as the
    solver's loop, and a stop test per iteration plus the last."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import mesh_accuracy
    finally:
        sys.path.remove(root)
    hv, G, _, cap, eps = _system(5, "spd", torch.float32, False)
    tests = []
    ns = types.SimpleNamespace(meta=types.SimpleNamespace(
        hp=HyperParams(cg_eps=eps, cg_max_iter=cap), dtype=torch.float32))
    S_t, it_t = mesh_accuracy._traced_cg_loop(tests)(ns, hv, G)
    S, it, _ = _loop(hv, G, None, torch.float32, cap, eps, group=3)
    assert it_t == it and torch.equal(_bits(S_t), _bits(S))
    assert len(tests) == it + 1
    assert all(r2 > thr for r2, thr in tests[:-1])
    assert not tests[-1][0] > tests[-1][1]


def _hv_problem(case: str):
    """(solver, state) at float64: ffm (identity, fused and self blocks),
    coo (both sides COO), mixed_head (a blocked u side with the head tier,
    a COO v side), skew (the head tier on both sides, fused fields), wide
    (FM fields above the lowered fused cap)."""
    if case == "ffm":
        return build_port(*ffm_problem("ffm_self", seed=3))
    if case in ("coo", "mixed_head"):
        from test_torch_coo import port as coo_port

        _, _, solver, state = coo_port(case, "ffm", seed=3)
        return solver, state
    if case == "skew":
        from test_torch_two_tier import port as tt_port
        from test_torch_two_tier import skewed_problem

        solver, state = tt_port(*skewed_problem("ffm", both=True, seed=3))
        assert solver.hd_u and solver.hd_v
        return solver, state
    from test_torch_wide import wide_problem

    return build_port(*wide_problem("fm_self", seed=3))


@pytest.mark.parametrize("case", ["ffm", "coo", "mixed_head", "skew",
                                  "wide"])
def test_hv_closures_read_their_solve_only_through_inputs(case,
                                                          monkeypatch):
    """The CUDA graph path builds each table's Hv closure once, on buffers,
    and copies every later solve's inputs into them: a closure made from
    one state's solve and handed another state's inputs (``cg_make``) must
    be that state's closure, bit for bit, on every block side (identity,
    fused, wide, self, COO, head tier)."""
    if case == "wide":
        from test_torch_wide import CAP as WIDE_CAP

        monkeypatch.setattr(torch_solver, "FUSED_TBL_D", WIDE_CAP)
    solver, state0 = _hv_problem(case)
    state1 = solver.epoch(state0)
    sa0, sb0 = solver.sasb(state0)
    sa1, sb1 = solver.sasb(state1)
    rng = np.random.default_rng(0)
    keys = set()
    for b in solver.blocks:
        for first in (True, False):
            hv0 = solver.solve_inputs(state0, b, first, sa0, sb0)[1]
            hv1 = solver.solve_inputs(state1, b, first, sa1, sb1)[1]
            assert hv0.cg_key == hv1.cg_key
            assert hv0.cg_inputs.keys() == hv1.cg_inputs.keys()
            keys.add(hv0.cg_key)
            dim = state0["params"][b.f12]["W" if first else "H"].shape[0]
            V = torch.from_numpy(rng.normal(size=(dim, solver.meta.hp.k)))
            copies = {n: t.clone() for n, t in hv1.cg_inputs.items()}
            got, want = hv0.cg_make(copies)(V), hv1(V)
            assert not torch.equal(hv0(V), want), (b.f12, first)
            assert torch.equal(_bits(got), _bits(want)), (b.f12, first)
    assert len(keys) == 2 * len(solver.blocks)
