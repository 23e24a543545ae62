"""The port's training epoch and evaluator on a data mesh of gloo ranks.

Each rank is a process (``parallel.distributed.spawn``, a ``file://``
rendezvous in ``tmp_path``) holding its rows, its slice of the shard-aligned
stream and its blocks of both layouts, with the tables replicated; the
ranks import torch and the port only (``torch_mesh_worker.py``).  At
float64 the mesh epoch must give the single-process port's tables (rtol
1e-9 / atol 1e-11) with equal CG counts, plain CG, Jacobi and without self
blocks (``tests/test_sharding.py:43-150``), and the JAX package's own mesh
epoch on its virtual CPU devices; the collectives must keep the JAX
solver's budget (``test_sharding.py:446-510``: one all-reduce and no
all-gather per CG iteration, one row all-gather per cross half-solve); the
evaluator sharded by users and by items must give the unsharded metrics at
rtol 1e-10 (``test_sharding.py:347-443``).  One spawned group runs all of a
module's checks."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import dense_to_padded, make_problem, oracle_params_to_jax
from one_class_ffm_torch.data.dataset import (
    Interactions,
    PaddedFields,
    pad_labels,
)
from one_class_ffm_torch.evalx.torch_eval import Evaluator, make_eval_data
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.parallel.mesh import Mesh, resolve_mesh
from one_class_ffm_torch.parallel.multihost import make_global_state
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import (
    params_from_numpy,
    params_to_numpy,
)
from one_class_ffm_torch.solver.params import HyperParams

torch.set_num_threads(1)

BM = 4  # rows per block at toy size
CASES = {"plain": dict(cg="none", self_side=True),
         "jacobi": dict(cg="jacobi", self_side=True),
         "ns": dict(cg="none", self_side=False)}


def _up(x, mult):
    return -(-x // mult) * mult


def host_views(prob, shards: int):
    """The port's host padded views of an OracleProblem on the layout of
    ``shards`` ranks (``conftest.to_device_problem``'s padding: one pad row,
    rows to a multiple of shards x BM), labels shard-aligned for more than
    one shard."""
    mult = shards * BM
    m_pad, n_pad = _up(prob.m + 1, mult), _up(prob.n + 1, mult)

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

    u = side(prob.Xu, prob.freq_u, m_pad)
    v = side(prob.Xv, prob.freq_v, n_pad)
    uu, vv = np.nonzero(prob.pos)
    indptr = np.zeros(prob.m + 1, np.int64)
    np.add.at(indptr, uu + 1, 1)
    y = pad_labels(Interactions(m=prob.m, n=prob.n, indptr=np.cumsum(indptr),
                                col=vv), m_pad, n_pad, dtype=np.float64,
                   shard_rows=m_pad // shards if shards > 1 else 0)
    return u, v, y


def problem(case: str, shards: int, seed: int = 0):
    """(port host problem for the ranks, oracle problem, oracle params)."""
    cfg = CASES[case]
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=19, n=13, self_side=cfg["self_side"],
                                cg_precond=cfg["cg"])
    u, v, y = host_views(prob, shards)
    lay = BlockLayout.make(prob.layout.Du, prob.layout.Dv, cfg["self_side"])
    hp = HyperParams(**dataclasses.asdict(prob.hp))
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    return dict(u=u, v=v, y=y, layout=lay, hp=hp, params=p_np, bm=BM), \
        prob, params


def single_process(pb, epochs: int = 1):
    """The port's epochs on one device, on the flat layout of the same
    problem (the same padding)."""
    meta, data = torch_solver.make_device_data(
        pb["u"], pb["v"], pb["y"], pb["layout"], pb["hp"],
        dtype=torch.float64, blocked_bm=BM, device="cpu")
    solver = torch_solver.FFMSolver(meta, data)
    st = solver.refresh_caches(
        {"params": params_from_numpy(pb["params"], "cpu", torch.float64)})
    obj = [float(solver.objective(st))]
    iters = []
    for _ in range(epochs):
        st, it = solver.epoch_stats(st)
        iters.append(it.tolist())
    obj.append(float(solver.objective(st)))
    return solver, st, iters, obj


def eval_inputs(seed: int = 3, m: int = 16, n: int = 16, ties: bool = False):
    """Host test data, tables and item side for the evaluator checks
    (``test_sharding.py``'s ``_eval_setup``)."""
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=m, n=n)
    lay = BlockLayout.make(prob.layout.Du, prob.layout.Dv, True)
    pads = [dense_to_padded(X, m) for X in prob.Xu]
    uva = PaddedFields(
        m=m, m_true=m, f=len(prob.Xu), Ds=tuple(X.shape[1] for X in prob.Xu),
        idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
        freq=tuple(np.ones(X.shape[1]) for X in prob.Xu),
        row_nnz=sum((X != 0).sum(axis=1) for X in prob.Xu).astype(np.int32))
    uva.row_nnz[3] = 0  # one cold user: the popularity prior
    if ties:  # a model of ties: every score of a user equal
        params = {name: {f12: np.zeros_like(t) for f12, t in tabs.items()}
                  for name, tabs in params.items()}
    Q = {b.f12: prob.Xv[b.fj] @ params["H"][b.f12]
         for b in lay.cross_blocks()}
    bt = np.zeros(n)
    for b in lay.item_self_blocks():
        bt = bt + np.sum((prob.Xv[b.fi] @ params["W"][b.f12])
                         * (prob.Xv[b.fj] @ params["H"][b.f12]), axis=1)
    return dict(uva=uva, va_labels=[np.nonzero(prob.pos[i])[0]
                                    for i in range(m)],
                popular=np.arange(n, 0, -1) / n, n=n, n_true=n, layout=lay,
                params={f12: {"W": params["W"][f12], "H": params["H"][f12]}
                        for f12 in params["W"]},
                Q=Q, bt=bt, chunk=4)


def unsharded_metrics(ev_in):
    emeta, edata = make_eval_data(
        ev_in["uva"], ev_in["va_labels"], ev_in["popular"],
        n_items=ev_in["n"], n_items_true=ev_in["n_true"],
        layout=ev_in["layout"], dtype=torch.float64, device="cpu")
    ev = Evaluator(emeta, edata, chunk=ev_in["chunk"])
    return ev.validate(params_from_numpy(ev_in["params"], "cpu",
                                         torch.float64),
                       {f: torch.from_numpy(q) for f, q in ev_in["Q"].items()},
                       torch.from_numpy(ev_in["bt"]))


# ---------------------------------------------------------------------------
# one group of 2 ranks and one of 4 for the whole module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    problems = {case: problem(case, 2)[0] for case in CASES}
    out = spawn("torch_mesh_worker:mesh_epochs", 2, args=(problems,),
                workdir=str(tmp_path_factory.mktemp("mesh2")))
    return problems, out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    problems = {"plain": problem("plain", 4, seed=1)[0]}
    epochs = spawn("torch_mesh_worker:mesh_epochs", 4,
                   args=(problems, 2),
                   workdir=str(tmp_path_factory.mktemp("mesh4")))
    ev_in = {"random": eval_inputs(), "ties": eval_inputs(seed=5,
                                                          ties=True)}
    evals = [spawn("torch_mesh_worker:sharded_eval", 4,
                   args=(ev_in[name], ("users", "items")),
                   workdir=str(tmp_path_factory.mktemp(f"eval4{name}")))
             for name in ev_in]
    return problems, epochs, ev_in, dict(zip(ev_in, evals))


def _assert_tables(got, ref, rtol=1e-9, atol=1e-11):
    for f12, blk in ref.items():
        for name in ("W", "H"):
            np.testing.assert_allclose(got[f12][name], blk[name], rtol=rtol,
                                       atol=atol, err_msg=f"{name}[{f12}]")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_epoch_matches_single_process(two_ranks, case):
    problems, out = two_ranks
    _, ref_state, ref_iters, ref_obj = single_process(problems[case])
    ref = params_to_numpy(ref_state["params"])
    for rank_out in out:
        got = rank_out[case]
        _assert_tables(got["params"], ref)
        assert got["iters"] == ref_iters
        np.testing.assert_allclose(got["obj"], ref_obj, rtol=1e-9)
        m_l, n_l, rank, size = got["rows"]
        np.testing.assert_allclose(
            got["a"], ref_state["a"].numpy()[rank * m_l:(rank + 1) * m_l],
            rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(
            got["b"], ref_state["b"].numpy()[rank * n_l:(rank + 1) * n_l],
            rtol=1e-9, atol=1e-11)


def test_mesh_ranks_hold_the_same_tables_and_counts(two_ranks):
    """The CG variable is replicated: every rank's recurrence gives the
    same bits and stops at the same iteration."""
    _, out = two_ranks
    for case in CASES:
        r0, r1 = out[0][case], out[1][case]
        assert r0["iters"] == r1["iters"]
        for f12, blk in r0["params"].items():
            for name in ("W", "H"):
                assert np.array_equal(blk[name], r1["params"][f12][name])


def test_mesh_state_stays_distributed(two_ranks):
    """Each rank holds half the rows of each side and half of each side's
    blocks; its stream slice holds its users' entries only."""
    problems, out = two_ranks
    pb = problems["plain"]
    for rank_out in out:
        got = rank_out["plain"]
        m_l, n_l, rank, size = got["rows"]
        assert (size, m_l, n_l) == (2, pb["u"].m // 2, pb["v"].m // 2)
        assert got["a"].shape == (m_l,) and got["b"].shape == (n_l,)
        assert np.all(got["pos_u"] // m_l == rank)


def test_mesh_stream_residual_matches_single_process(two_ranks):
    """The carried residual, read back in stream order on each rank's
    slice, is the single-process one at the same (user, item) pairs."""
    problems, out = two_ranks
    solver, st, _, _ = single_process(problems["jacobi"])
    ref = solver.yt_stream(st).numpy()
    ref_key = {(int(u), int(v)): x for u, v, x, w in zip(
        solver.data["pos_u"], solver.data["pos_v"], ref,
        solver.data["pos_w"]) if w > 0}
    seen = 0
    for rank_out in out:
        got = rank_out["jacobi"]
        for u, v, x in zip(got["pos_u"], got["pos_v"], got["yt_stream"]):
            if (int(u), int(v)) in ref_key:
                np.testing.assert_allclose(x, ref_key[(int(u), int(v))],
                                           rtol=1e-9, atol=1e-11)
                seen += 1
    assert seen == len(ref_key)


def _census(rows):
    """{(op, site, scope): calls} of a rank's census."""
    return {(o, site, s): c for o, site, s, c, _ in rows}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_epoch_collective_census(two_ranks, case):
    """The JAX solver's budget (test_sharding.py:446-510): inside each CG
    iteration exactly one all-reduce (Hv's table-space output) and never an
    all-gather; per cross half-solve one all-gather of the other side's
    cache rows; per half-solve one all-gather of the carry's propagation;
    the whole epoch within the JAX test's bounds."""
    problems, out = two_ranks
    lay = problems[case]["layout"]
    n_halves = 2 * len(lay.all_blocks())
    n_cross = 2 * len(lay.cross_blocks())
    for rank_out in out:
        got = rank_out[case]
        cen = _census(got["census"])
        in_cg = {k: c for k, c in cen.items() if k[2] == "cg"}
        assert in_cg == {("all_reduce", "hv", "cg"): sum(got["iters"][0])}
        assert cen[("all_gather", "rows_pre", "solve")] == n_cross
        assert cen[("all_gather", "carry", "solve")] == n_halves
        gathers = sum(c for k, c in cen.items() if k[0] == "all_gather")
        reduces = sum(c for k, c in cen.items()
                      if k[0] == "all_reduce" and k[2] != "cg")
        assert gathers <= 2 * n_halves
        assert reduces <= 4 * n_halves


def test_four_rank_epochs_match_single_process(four_ranks):
    """Four ranks, two epochs, the same tables and CG counts."""
    problems, out, _, _ = four_ranks
    _, ref_state, ref_iters, ref_obj = single_process(problems["plain"],
                                                      epochs=2)
    ref = params_to_numpy(ref_state["params"])
    for rank_out in out:
        got = rank_out["plain"]
        assert got["rows"][3] == 4
        _assert_tables(got["params"], ref)
        assert got["iters"] == ref_iters
        np.testing.assert_allclose(got["obj"], ref_obj, rtol=1e-9)


@pytest.mark.parametrize("by", ["users", "items"])
@pytest.mark.parametrize("name", ["random", "ties"])
def test_sharded_evaluator_matches(four_ranks, by, name):
    """Every metric (the P@K ladder, nDCG, ploss, AUC, the cold user's
    popularity prior, ties to the lowest id) of the evaluator sharded by
    users and by items equals the unsharded evaluator's."""
    _, _, ev_in, evals = four_ranks
    ref = unsharded_metrics(ev_in[name])
    for rank_out in evals[name]:
        got = rank_out[by]["metrics"]
        assert got.keys() == ref.keys()
        for key, val in ref.items():
            np.testing.assert_allclose(got[key], val, rtol=1e-10,
                                       err_msg=key)


def test_sharded_evaluator_collectives(four_ranks):
    """By users: the item side gathered once and one all-reduce of the
    sums; by items: per chunk the label scores, rank counts and ploss
    all-reduced and the top-K candidates gathered."""
    _, _, ev_in, evals = four_ranks
    n_chunks = -(-16 // ev_in["random"]["chunk"])
    for rank_out in evals["random"]:
        users = _census(rank_out["users"]["census"])
        assert users[("all_reduce", "eval", "solve")] == 1
        items = _census(rank_out["items"]["census"])
        assert items[("all_reduce", "eval", "solve")] == 3 * n_chunks
        assert items[("all_gather", "eval", "solve")] == 2 * n_chunks


def test_shard_items_rejects_an_indivisible_catalog():
    ev_in = eval_inputs(n=15)
    emeta, edata = make_eval_data(
        ev_in["uva"], ev_in["va_labels"], ev_in["popular"], n_items=15,
        n_items_true=15, layout=ev_in["layout"], dtype=torch.float64,
        device="cpu")

    class FourRanks:
        size = 4

    with pytest.raises(ValueError, match="not divisible"):
        Evaluator(emeta, edata).shard_items(FourRanks())


# ---------------------------------------------------------------------------
# against the JAX package's mesh epoch (8 virtual CPU devices, conftest)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "jacobi"])
def test_mesh_epoch_matches_jax_mesh_epoch(two_ranks, case, monkeypatch):
    """The JAX package's shard-aligned epoch on a 2-device mesh of its
    virtual CPU devices (kt and fused table kernels in interpret mode, the
    slot-order carry, shard_map-local passes with psum'd table outputs)
    gives the port's mesh tables and CG counts."""
    import jax

    from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
    from one_class_ffm_tpu.solver import jax_solver

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    monkeypatch.setenv("OCFFM_KT", "interpret")
    monkeypatch.setenv("OCFFM_FUSED_TBL", "interpret")
    problems, out = two_ranks
    _, prob, params = problem(case, 2)
    pb = problems[case]
    meta, data = jax_solver.make_device_data(
        pb["u"], pb["v"], pb["y"], prob.layout, prob.hp,
        dtype=jax.numpy.float64, blocked_bm=BM, blocked_shards=2)
    mesh = make_mesh(2)
    solver = jax_solver.FFMSolver(meta, shard_data(data, mesh), mesh=mesh)
    assert solver.blk_yt and solver.kt_u and solver.kt_v
    state = shard_state(
        solver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    state, iters = solver.epoch_stats(state)
    ref = {f12: {n: np.asarray(t) for n, t in blk.items()}
           for f12, blk in state["params"].items()}
    for rank_out in out:
        _assert_tables(rank_out[case]["params"], ref)
        assert rank_out[case]["iters"][0] == np.asarray(iters).tolist()


# ---------------------------------------------------------------------------
# what waits for ROADMAP A11b
# ---------------------------------------------------------------------------


def _a11b_cases():
    pb, _, _ = problem("plain", 2)

    def flat_data_under_mesh():
        meta, data = torch_solver.make_device_data(
            pb["u"], pb["v"], pb["y"], pb["layout"], pb["hp"],
            dtype=torch.float64, blocked_bm=BM, device="cpu")
        torch_solver.FFMSolver(meta, data, mesh=Mesh(1, 0, "cpu"))
        # a 2-rank mesh over the flat layout: the JAX sharded fallback
        fake = type("TwoRanks", (), {"size": 2, "rank": 0})()
        torch_solver.FFMSolver(meta, data, mesh=fake)

    def coo_under_mesh():
        torch_solver.make_device_data(
            pb["u"], pb["v"], pb["y"], pb["layout"], pb["hp"],
            dtype=torch.float64, blocked_bm=0, device="cpu",
            blocked_shards=2)

    def head_tier_under_mesh():
        skew, _, _ = problem("plain", 2)
        # four power users beyond the pad budget, head chunks of 8
        rng = np.random.default_rng(0)
        prob, _ = make_problem(rng, m=64, n=40, density=0.05,
                               cg_precond="none")
        prob.pos[:4, :] = True
        u, v, y = host_views(prob, 2)
        lay = BlockLayout.make(prob.layout.Du, prob.layout.Dv, True)
        torch_solver.make_device_data(
            u, v, y, lay, skew["hp"], dtype=torch.float64, blocked_bm=BM,
            head_chunk=8, device="cpu", blocked_shards=2)

    return {
        "model_axis_mesh": lambda: resolve_mesh("2x2"),
        "model_sharded_state": lambda: make_global_state(
            {"params": {}}, Mesh(1, 0, "cpu"), model_min_rows=8),
        "flat_data_under_mesh": flat_data_under_mesh,
        "coo_under_mesh": coo_under_mesh,
        "head_tier_under_mesh": head_tier_under_mesh,
    }


@pytest.mark.parametrize("case", ["model_axis_mesh", "model_sharded_state",
                                  "flat_data_under_mesh", "coo_under_mesh",
                                  "head_tier_under_mesh"])
def test_a11b_cases_raise(case):
    """The 2-D data x model mesh, tables row-sharded on a model axis, the
    plain COO passes and the head tier under a mesh wait for ROADMAP
    A11b, and say so."""
    with pytest.raises(NotImplementedError, match="ROADMAP A11b"):
        _a11b_cases()[case]()


def test_mesh_spec_must_match_the_ranks():
    """``--mesh N`` in a run of another number of ranks names the launch
    that forms it; ``Nx1`` is ``N``; no spec, no mesh."""
    assert resolve_mesh(None) is None and resolve_mesh("") is None
    assert resolve_mesh("1x1").size == 1 and resolve_mesh("auto").size == 1
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        resolve_mesh("2")
