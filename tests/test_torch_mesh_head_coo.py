"""The head tier and the plain COO passes of the port on a data mesh of
gloo ranks.

Each rank is a process (``parallel.distributed.spawn``) that imports torch
and the port only (``torch_mesh_worker.py``).  A two-tier side keeps the
head chunks of its own rows on each rank (a power item's chunks on the
item's rank, reading the users' gathered cache); a COO side sums through
its list of its entries of the rank's rows (the u side's stream slice, the
v side's entries of the rank's items), reading the other side's gathered
cache.  At float64 the mesh epochs must give the single-process
port's tables (rtol 1e-9 / atol 1e-11) with equal CG counts, and the JAX
package's: its two-tier mesh epoch (``tests/test_two_tier.py:171``), its
flat-layout mesh epoch (``tests/test_sharding.py:43``) and its sharded
fallback (a u side blocked beside a v side the builder rejects).  Inside CG
each Hv makes exactly one all-reduce and no all-gather."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from conftest import make_problem, oracle_params_to_jax
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.solver.convert import params_to_numpy
from one_class_ffm_torch.solver.params import HyperParams
from test_torch_sharding import (
    BM,
    _assert_tables,
    _census,
    host_views,
    problem,
    single_process,
)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
CHUNK = 8  # head chunk width at toy size
EPOCHS = 2


def skewed(seed: int, m: int, n: int, density: float, u_head: bool,
           cg: str = "none", head_chunk: int = CHUNK):
    """``test_two_tier.py``'s skewed problem (every user likes item 0; with
    ``u_head`` user 0 likes every item) on the layout of 2 ranks: (port
    host problem, oracle problem, oracle params)."""
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=m, n=n, self_side=True,
                                density=density, cg_precond=cg)
    pos = np.asarray(prob.pos).copy()
    pos[:, 0] = True
    if u_head:
        pos[0, :] = True
    prob.pos = pos
    u, v, y = host_views(prob, 2)
    lay = BlockLayout.make(prob.layout.Du, prob.layout.Dv, True)
    hp = HyperParams(**dataclasses.asdict(prob.hp))
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    return dict(u=u, v=v, y=y, layout=lay, hp=hp, params=p_np, bm=BM,
                head_chunk=head_chunk), prob, params


# name -> (builder, the head / COO sides it must take: (hd_u, hd_v), (coo
# u, coo v))
CASES = {
    "head_v": (lambda: skewed(0, 160, 24, 0.05, False),
               (False, True), (False, False)),
    "head_both": (lambda: skewed(0, 160, 64, 0.03, True),
                  (True, True), (False, False)),
    "head_both_jacobi": (lambda: skewed(0, 160, 64, 0.03, True, "jacobi"),
                         (True, True), (False, False)),
    "coo": (lambda: _flat("plain"), (False, False), (True, True)),
    "coo_jacobi": (lambda: _flat("jacobi"), (False, False), (True, True)),
    "coo_ns": (lambda: _flat("ns"), (False, False), (True, True)),
    "mixed": (lambda: skewed(0, 160, 24, 0.05, False, head_chunk=0),
              (False, False), (False, True)),
    "mixed_jacobi": (lambda: skewed(0, 160, 24, 0.05, False, "jacobi",
                                    head_chunk=0),
                     (False, False), (False, True)),
}


def _flat(case: str):
    """``test_sharding.py:43``'s problem with both sides COO
    (``blocked_bm=0``) on the shard-aligned stream of 2 ranks."""
    pb, prob, params = problem(case, 2)
    return dict(pb, bm=0), prob, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    problems = {name: CASES[name][0]()[0] for name in CASES}
    out = spawn("torch_mesh_worker:mesh_epochs", 2,
                args=(problems, EPOCHS),
                workdir=str(tmp_path_factory.mktemp("mesh_head_coo")))
    return problems, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_epochs_match_single_process(ranks, case):
    """Two epochs on 2 ranks give the single-process port's tables, CG
    counts and objectives; each side takes the head tier or the COO passes
    the case names."""
    problems, out = ranks
    _, ref_state, ref_iters, ref_obj = single_process(problems[case],
                                                      epochs=EPOCHS)
    ref = params_to_numpy(ref_state["params"])
    _, hd, coo = CASES[case]
    for rank_out in out:
        got = rank_out[case]
        assert got["hd"] == hd and got["coo"] == coo
        _assert_tables(got["params"], ref)
        assert got["iters"] == ref_iters
        np.testing.assert_allclose(got["obj"], ref_obj, rtol=1e-9)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_census_one_all_reduce_per_hv(ranks, case):
    """Inside CG each Hv makes exactly one all-reduce (the head rows'
    partial sums are added into it) and no all-gather; per half-solve one
    all-gather of the carry, and per cross half-solve one of the other
    side's cache rows (a blocked side's stream and head chunks and a COO
    side's list read them)."""
    problems, out = ranks
    lay = problems[case]["layout"]
    n_halves = len(lay.all_blocks()) * 2
    rows_pre = 2 * len(lay.cross_blocks())
    for rank_out in out:
        got = rank_out[case]
        cen = _census(got["census"])
        in_cg = {k: c for k, c in cen.items() if k[2] == "cg"}
        assert in_cg == {("all_reduce", "hv", "cg"): sum(map(sum,
                                                             got["iters"]))}
        assert cen[("all_gather", "carry", "solve")] == EPOCHS * n_halves
        assert cen[("all_gather", "rows_pre", "solve")] == EPOCHS * rows_pre
        assert not any(k[0].endswith("@model") for k in cen)


def test_head_chunks_live_on_their_rows_rank(ranks):
    """Each rank holds the head rows of its own rows: the power item 0 on
    rank 0's items, the power user 0 on rank 0's users; rank 1 keeps one
    row of its own with pad chunks only."""
    problems, out = ranks
    for r, rank_out in enumerate(out):
        got = rank_out["head_both"]
        m_l, n_l, rank, size = got["rows"]
        assert rank == r and size == 2
        for s, rows in (("u", m_l), ("v", n_l)):
            hd = got["hd_rows"][s]
            assert np.all((hd >= 0) & (hd < rows))
            if r == 0:
                assert 0 in hd  # the power row, local index 0


@pytest.mark.parametrize("both_sides", [False, True])
def test_head_mesh_matches_jax_two_tier_mesh(ranks, both_sides, monkeypatch):
    """The JAX package's two-tier mesh epoch (carry mode, shard_map-local
    tail passes, head ops at jit level) on 2 of its virtual CPU devices,
    kt and fused kernels in interpret mode, gives the port's mesh tables
    and CG counts."""
    import jax

    from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
    from one_class_ffm_tpu.solver import jax_solver

    monkeypatch.setenv("OCFFM_HEAD_CHUNK", str(CHUNK))
    monkeypatch.setenv("OCFFM_KT", "interpret")
    monkeypatch.setenv("OCFFM_FUSED_TBL", "interpret")
    name = "head_both" if both_sides else "head_v"
    _, out = ranks
    pb, prob, params = CASES[name][0]()
    meta, data = jax_solver.make_device_data(
        pb["u"], pb["v"], pb["y"], prob.layout, prob.hp,
        dtype=jax.numpy.float64, blocked_bm=BM, blocked_shards=2)
    mesh = make_mesh(2)
    solver = jax_solver.FFMSolver(meta, shard_data(data, mesh), mesh=mesh)
    assert solver.hd_v and solver.hd_u == both_sides and solver.blk_yt
    state = shard_state(
        solver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    iters = []
    for _ in range(EPOCHS):
        state, it = solver.epoch_stats(state)
        iters.append(np.asarray(it).tolist())
    ref = {f12: {n: np.asarray(t) for n, t in blk.items()}
           for f12, blk in state["params"].items()}
    for rank_out in out:
        _assert_tables(rank_out[name]["params"], ref)
        assert rank_out[name]["iters"] == iters


def _jax_epochs(solver, state):
    iters = []
    for _ in range(EPOCHS):
        state, it = solver.epoch_stats(state)
        iters.append(np.asarray(it).tolist())
    return {f12: {n: np.asarray(t) for n, t in blk.items()}
            for f12, blk in state["params"].items()}, iters


@pytest.mark.parametrize("case", ["coo", "coo_jacobi"])
def test_coo_mesh_matches_jax_flat_layout_mesh(ranks, case):
    """The JAX package's flat-layout epoch (plain COO ops, GSPMD-split
    stream) on a 2-device mesh gives the port's both-COO mesh tables and
    CG counts: the port keeps the shard-aligned stream, the agreement is
    numeric."""
    from conftest import to_device_problem
    from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    _, out = ranks
    _, prob, params = CASES[case][0]()
    meta, data = to_device_problem(prob, row_pad=1, multiple=2 * BM)
    mesh = make_mesh(2)
    solver = FFMSolver(meta, shard_data(data, mesh))
    state = shard_state(
        solver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    ref, iters = _jax_epochs(solver, state)
    for rank_out in out:
        _assert_tables(rank_out[case]["params"], ref)
        assert rank_out[case]["iters"] == iters


@pytest.mark.parametrize("case", ["mixed", "mixed_jacobi"])
def test_mixed_mesh_matches_jax_sharded_fallback(ranks, case, monkeypatch):
    """A u side blocked and shard-aligned beside a v side the blocked
    builder rejects (the skewed v side without the head tier): the JAX
    package's sharded fallback (u-side blocked passes under shard_map, the
    v side's plain COO ops under GSPMD) gives the port's mesh tables and
    CG counts."""
    import jax

    from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
    from one_class_ffm_tpu.solver import jax_solver

    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "0")
    _, out = ranks
    pb, prob, params = CASES[case][0]()
    meta, data = jax_solver.make_device_data(
        pb["u"], pb["v"], pb["y"], prob.layout, prob.hp,
        dtype=jax.numpy.float64, blocked_bm=BM, blocked_shards=2)
    assert meta.blocked_bm_u == BM and meta.blocked_bm_v == 0
    mesh = make_mesh(2)
    solver = jax_solver.FFMSolver(meta, shard_data(data, mesh), mesh=mesh)
    assert not solver.blk_yt  # the fallback, not the carry mode
    state = shard_state(
        solver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    ref, iters = _jax_epochs(solver, state)
    for rank_out in out:
        _assert_tables(rank_out[case]["params"], ref)
        assert rank_out[case]["iters"] == iters


# ---------------------------------------------------------------------------
# the Trainer and the command line with --blocked-bm 0 on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    d = tmp_path_factory.mktemp("coo_mesh_data")
    return write_dataset(str(d), SynthSpec(n_users=150, n_items=50,
                                           avg_pos=6.0, seed=7))


def test_trainer_coo_mesh_matches_single_device(dataset, tmp_path):
    """``Trainer`` with ``mesh_shape="2"`` and ``blocked_bm=0`` on 2 ranks:
    both sides COO on the shard-aligned stream; the log rows, CG counts,
    metrics, tables and top-7 ids equal one process's."""
    sys.path.insert(0, TESTS)
    import torch_mesh_worker

    item, train, va = dataset
    cfg = dict(item_path=item, train_path=train, test_path=va, k=4,
               nr_pass=3, eval_every=3, dtype="float64", blocked_bm=0,
               eval_chunk=16)
    ref = torch_mesh_worker.trainer_run(dict(cfg, row_multiple=8), 7)
    outs = spawn("torch_mesh_worker:trainer_run", 2,
                 args=(dict(cfg, mesh_shape="2", distributed=True), 7),
                 workdir=str(tmp_path))
    for r, got in enumerate(outs):
        assert got["size"] == 2 and got["writer"] == (r == 0)
        assert got["rows"] == ref["rows"] and got["iters"] == ref["iters"]
        for key, val in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], val, rtol=1e-9,
                                       err_msg=key)
        _assert_tables(got["params"], ref["params"])
        np.testing.assert_array_equal(got["top"], ref["top"])


def test_cli_coo_mesh_under_torchrun_environment(dataset, tmp_path, capsys):
    """``python -m one_class_ffm_torch ... --mesh 2 --blocked-bm 0
    --distributed`` started as torchrun starts it: rank 0 prints the
    single-process run's rows, rank 1 nothing."""
    from one_class_ffm_torch import cli
    from test_torch_multihost import _torchrun

    item, train, va = dataset
    argv = [item, train, "-p", va, "-k", "4", "-t", "2", "--eval-every",
            "2", "--platform", "cpu", "--dtype", "float64", "--blocked-bm",
            "0", "--eval-chunk", "16"]
    assert cli.main(argv) == 0
    ref = capsys.readouterr().out
    outs = _torchrun(["-m", "one_class_ffm_torch", *argv, "--mesh", "2",
                      "--distributed"], 2)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{err[-3000:]}"
    assert outs[0][1] == ref
    assert outs[1][1] == ""


# ---------------------------------------------------------------------------
# chip_smoke's [mesh ffm-skew] and [mesh ffm-coo], rehearsed on the CPU
# ---------------------------------------------------------------------------


def _rehearse(tmp_path, monkeypatch, spec):
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "MESH_CHECK_USERS", 200)
    report = chip_smoke.new_report()
    got = chip_smoke.mesh_phase(torch.device("cpu"), "cpu", report, spec)
    assert not any(got.values())  # no kernel launches on the CPU
    assert not any(r["max_abs_err"] for r in report.values())
    return chip_smoke


def test_chip_smoke_mesh_skew_rehearsed_on_the_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """``[mesh ffm-skew]`` at toy size on the CPU (the plain versions in
    place of the kernels): a popularity-skewed FFM (``reshard`` of a
    flat build, as the phase reuses ``[main ffm-skew]``'s arrays), the
    head tier on its v side under 2 ranks, every check but the kernels'."""
    import pickle

    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    # a power item (every user's positive) beyond the pad budget of
    # 32-row blocks: its head chunks of 8 on rank 0
    data = chip_smoke.build_data(600, 300, 5.0, seed=0, self_side=True,
                                 pop_skew=1.0, power=1, dims_u=(600, 12),
                                 dims_v=(300, 8))
    path = str(tmp_path / "skew.pkl")
    with open(path, "wb") as fh:
        pickle.dump(chip_smoke.reshard(data, 512, 2), fh)
    spec = dict(chip_smoke.MESH_PATHS["skew"], data=path,
                trainer=dict(head_chunk=8, blocked_bm=32))
    _rehearse(tmp_path, monkeypatch, spec)
    out = capsys.readouterr().out
    assert out.count("[mesh ffm-skew] rank 1 epoch 2") == 2
    assert "half-solve uv id v" in out
    assert "'v': (" in out  # the v side's head tier on each rank


def test_chip_smoke_mesh_coo_rehearsed_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """``[mesh ffm-coo]`` at toy size on the CPU: the FFM with both sides
    COO on 2 ranks, every check but the kernels'."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    spec = dict(chip_smoke.MESH_PATHS["coo"], n_users=600, n_items=300,
                dims=dict(dims_u=(600, 12), dims_v=(300, 8)))
    _rehearse(tmp_path, monkeypatch, spec)
    out = capsys.readouterr().out
    assert out.count("[mesh ffm-coo] rank 1 epoch 2") == 2
    assert "COO sides u and v" in out
    assert "half-solve uv field v" in out and "half-solve vv" in out


@pytest.mark.parametrize("kind", ["coo", "blocked"])
def test_float32_mesh_half_solves_equal_one_process(kind, tmp_path,
                                                    monkeypatch):
    """At float32 a 2-rank mesh's half-solves from one state equal the one
    process's (``mesh_accuracy.py`` at toy size): the sums over a side's
    rows accumulate at float64 (``FFMSolver._row_sums``), so the ranks'
    split sums round as the one process's whole ones.  A categorical
    field's u half, whose table-space partials are all-reduced, and the
    step, whose CG recurrence all-reduces its inner products, may part by
    rounding."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke
    import mesh_accuracy

    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    errs = mesh_accuracy.run(kind, "cpu", 2000, 400)
    assert {label for label, _ in errs} >= {"uv id v", "vv", "uu"}
    for (label, key), e in errs.items():
        if label in ("uv field", "uv fused") or key == "T":
            assert e["mesh_vs_one"] <= 1e-6, (label, key, e)
        else:
            assert e["mesh_vs_one"] == 0.0, (label, key, e)
        assert e["one_vs_64"] <= 1e-3, (label, key, e)
