"""The port's 2-D ``data x model`` mesh on gloo ranks, and ``d_multiple``.

Four ranks (``parallel.distributed.spawn``, torch and the port only:
``torch_mesh_worker.py``) form a ``2x2`` mesh: rank r at data index r // 2
and model index r % 2; rows, the stream and the layouts on the data axis,
every block table of at least ``model_min_rows`` rows (padded to a multiple
of 2 by ``d_multiple``) row-sharded on the model axis.  At float64 the
mesh epochs must give the one-process port's tables at true dims (rtol
1e-9 / atol 1e-11) with equal CG counts and pad rows exactly 0, and the
JAX package's ``make_mesh2`` epoch (``tests/test_sharding.py:185-308``);
inside CG each Hv makes one data-axis all-reduce and nothing else, and a
half-solve gathers its model-sharded table once.  The JAX package's own
2-D census (the compiled HLO of its Trainer's ``2x2`` epoch on
``dryrun_multichip``'s problem) is measured beside it."""

import dataclasses
import os
import re
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from conftest import make_problem
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.parallel.mesh import Mesh, shard_params_model
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import (
    pad_table,
    params_from_numpy,
    params_to_numpy,
)
from one_class_ffm_torch.solver.params import HyperParams
from test_torch_mesh_head_coo import skewed
from test_torch_sharding import BM, _census, host_views, single_process

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
EPOCHS = 2
MIN_ROWS = 8


def _problem(seed: int, cg: str = "none", self_side: bool = True,
             Du=(7, 5), Dv=(6, 4)):
    """A toy problem (``test_sharding.py``'s sizes) on the layout of 2 data
    ranks: (port host problem, oracle problem, oracle params)."""
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=19, n=13, Du=Du, Dv=Dv,
                                self_side=self_side, cg_precond=cg)
    u, v, y = host_views(prob, 2)
    lay = BlockLayout.make(prob.layout.Du, prob.layout.Dv, self_side)
    hp = HyperParams(**dataclasses.asdict(prob.hp))
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    return dict(u=u, v=v, y=y, layout=lay, hp=hp, params=p_np,
                bm=BM), prob, params


MESH2 = dict(mesh="2x2", model_min_rows=MIN_ROWS, d_multiple=2)
CASES = {
    "plain": lambda: _problem(0),
    "jacobi": lambda: _problem(1, "jacobi"),
    "ns": lambda: _problem(2, self_side=False),
    # prime dims (test_sharding.py:263): 13 and 11 rows, padded to 14, 12
    "prime": lambda: _problem(3, Du=(13, 5), Dv=(11, 4)),
    # the head tier and the COO passes on the 2-D mesh
    "skew": lambda: skewed(0, 160, 24, 0.05, False),
    "coo": lambda: (lambda pb, p, q: (dict(pb, bm=0), p, q))(*_problem(4)),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    problems = {name: dict(CASES[name]()[0], **MESH2) for name in CASES}
    out = spawn("torch_mesh_worker:mesh_epochs", 4,
                args=(problems, EPOCHS),
                workdir=str(tmp_path_factory.mktemp("mesh_2d")))
    return problems, out


def _one_process(pb):
    """The one-process port on the same host problem, without the mesh
    keys (true dims)."""
    pb = {k: v for k, v in pb.items() if k not in MESH2}
    return single_process(pb, epochs=EPOCHS)


def _assert_true_rows(got, ref):
    for f12, blk in ref.items():
        for name in ("W", "H"):
            d = blk[name].shape[0]
            np.testing.assert_allclose(got[f12][name][:d], blk[name],
                                       rtol=1e-9, atol=1e-11,
                                       err_msg=f"{name}[{f12}]")
            assert np.all(got[f12][name][d:] == 0.0), \
                f"pad rows of {name}[{f12}] moved"


@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_epochs_match_one_process(ranks, case):
    """Two epochs on the 2x2 mesh give the one-process port's tables at
    their true rows, its CG counts and objectives; every pad row of a
    ``d_multiple``-padded table stays exactly 0."""
    problems, out = ranks
    _, ref_state, ref_iters, ref_obj = _one_process(problems[case])
    ref = params_to_numpy(ref_state["params"])
    for rank_out in out:
        got = rank_out[case]
        _assert_true_rows(got["params"], ref)
        assert got["iters"] == ref_iters
        np.testing.assert_allclose(got["obj"], ref_obj, rtol=1e-9)


def _sharded_tables(lay, pad):
    """{(f12, name): padded rows} of the tables row-sharded at MIN_ROWS."""
    return {(b.f12, name): pad(d) for b in lay.all_blocks()
            for name, d in (("W", b.d1), ("H", b.d2))
            if pad(d) >= MIN_ROWS}


def test_2d_tables_row_sharded_on_the_model_axis(ranks):
    """Each rank holds its model index's rows of every table of at least
    ``model_min_rows`` (padded) rows, the two model ranks' parts making
    the table, and the smaller tables whole; its rows of the caches are
    its data index's."""
    problems, out = ranks
    pad = lambda d: -(-d // 2) * 2  # noqa: E731
    lay = problems["prime"]["layout"]
    big = _sharded_tables(lay, pad)
    assert big and len(big) < 2 * len(lay.all_blocks())
    for r, rank_out in enumerate(out):
        got = rank_out["prime"]
        m_l, n_l, rank, size = got["rows"]
        model_rank, n_model = got["model"]
        assert (rank, model_rank, size, n_model) == (r // 2, r % 2, 2, 2)
        for b in lay.all_blocks():
            for name, d in (("W", b.d1), ("H", b.d2)):
                held = got["held"][b.f12][name]
                whole = got["params"][b.f12][name]
                if (b.f12, name) in big:
                    rows = pad(d) // 2
                    sl = slice(model_rank * rows, (model_rank + 1) * rows)
                    np.testing.assert_array_equal(held, whole[sl])
                else:
                    np.testing.assert_array_equal(held, whole)
        assert got["a"].shape[0] == problems["prime"]["u"].m // 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_census(ranks, case):
    """Inside CG one data-axis all-reduce per Hv and nothing else; per
    half-solve of a model-sharded table one model-axis all-gather of it
    (the other readers' gathers are outside the epochs' census)."""
    problems, out = ranks
    pb = problems[case]
    pad = lambda d: -(-d // 2) * 2  # noqa: E731
    n_big = len(_sharded_tables(pb["layout"], pad))
    for rank_out in out:
        got = rank_out[case]
        cen = _census(got["census"])
        in_cg = {k: c for k, c in cen.items() if k[2] == "cg"}
        assert in_cg == {("all_reduce", "hv", "cg"): sum(map(sum,
                                                             got["iters"]))}
        model = {k: c for k, c in cen.items() if k[0].endswith("@model")}
        assert model == {("all_gather@model", "table", "solve"):
                         EPOCHS * n_big}


@pytest.mark.parametrize("case", ["plain", "prime"])
def test_2d_matches_jax_make_mesh2(ranks, case):
    """The JAX package's epoch on its ``make_mesh2(2, 2)`` mesh (rows on
    data, tables of at least 8 rows row-sharded on model by
    ``shard_state(model_min_rows=8)``, table dims padded by
    ``d_multiple=2``) gives the port's padded tables and CG counts."""
    import jax.numpy as jnp

    from conftest import to_device_problem
    from one_class_ffm_tpu.parallel import shard_data, shard_state
    from one_class_ffm_tpu.parallel.mesh import make_mesh2
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    _, out = ranks
    _, prob, params = CASES[case]()
    meta, data = to_device_problem(prob, row_pad=1, multiple=2 * BM,
                                   d_multiple=2)
    mesh2 = make_mesh2(2, 2)
    solver = FFMSolver(meta, shard_data(data, mesh2))
    jparams = {f12: {name: jnp.asarray(pad_table(params[name][f12],
                                                 meta.pad_d))
                     for name in ("W", "H")} for f12 in params["W"]}
    state = shard_state(solver.refresh_caches({"params": jparams}), mesh2,
                        model_min_rows=MIN_ROWS)
    assert any(not t.sharding.is_fully_replicated
               for blk in state["params"].values() for t in blk.values())
    iters = []
    for _ in range(EPOCHS):
        state, it = solver.epoch_stats(state)
        iters.append(np.asarray(it).tolist())
    for rank_out in out:
        got = rank_out[case]
        for f12, blk in state["params"].items():
            for name, t in blk.items():
                np.testing.assert_allclose(got["params"][f12][name],
                                           np.asarray(t), rtol=1e-9,
                                           atol=1e-11)
        assert got["iters"] == iters


def test_padded_tables_match_unpadded_on_one_process():
    """``d_multiple`` padding is a pure layout transform on one process
    (``test_sharding.py:239``): the true rows evolve as without it, pad
    rows stay exactly 0 through two epochs, the objective is the same; the
    JAX package's padded solver gives the same padded tables
    (``convert`` pads them on the way in and strips them on the way
    out)."""
    import jax.numpy as jnp

    from conftest import to_device_problem
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver as JaxSolver

    pb, prob, params = _problem(5, Du=(13, 5), Dv=(7, 4))
    runs = {}
    for mult in (1, 8):
        meta, data = torch_solver.make_device_data(
            pb["u"], pb["v"], pb["y"], pb["layout"], pb["hp"],
            dtype=torch.float64, blocked_bm=BM, device="cpu",
            d_multiple=mult)
        solver = torch_solver.FFMSolver(meta, data)
        st = solver.refresh_caches({"params": params_from_numpy(
            pb["params"], "cpu", torch.float64, pad_d=meta.pad_d)})
        for _ in range(2):
            st = solver.epoch(st)
        runs[mult] = (meta, params_to_numpy(st["params"]),
                      float(solver.objective(st)))
    meta8, got, obj8 = runs[8]
    _, ref, obj1 = runs[1]
    _assert_true_rows(got, ref)
    np.testing.assert_allclose(obj8, obj1, rtol=1e-9)
    dims = {b.f12: dict(W=b.d1, H=b.d2) for b in pb["layout"].all_blocks()}
    stripped = params_to_numpy(params_from_numpy(got, "cpu", torch.float64),
                               dims)
    for f12, blk in ref.items():
        for name in ("W", "H"):
            assert stripped[f12][name].shape == blk[name].shape

    jmeta, jdata = to_device_problem(prob, row_pad=1, multiple=2 * BM,
                                     d_multiple=8)
    jsolver = JaxSolver(jmeta, jdata)
    jst = jsolver.refresh_caches({"params": {
        f12: {name: jnp.asarray(pad_table(params[name][f12], jmeta.pad_d))
              for name in ("W", "H")} for f12 in params["W"]}})
    for _ in range(2):
        jst = jsolver.epoch(jst)
    for f12, blk in jst["params"].items():
        for name, t in blk.items():
            np.testing.assert_allclose(got[f12][name], np.asarray(t),
                                       rtol=1e-9, atol=1e-11)


def test_nondivisible_large_table_raises():
    """A large table whose rows do not divide the model axis is an error
    naming ``d_multiple`` (``test_sharding.py:298``), never a silent
    replication; with the rows padded it shards."""
    mesh = Mesh(2, 0, "cpu", n_model=4, model_rank=1)
    params = {0: {"W": torch.zeros(13, 3), "H": torch.zeros(16, 3)}}
    with pytest.raises(ValueError, match="d_multiple=4"):
        shard_params_model(params, mesh, min_rows=8)
    params[0]["W"] = torch.arange(16.0)[:, None].expand(16, 3)
    got = shard_params_model(params, mesh, min_rows=8)
    assert torch.equal(got[0]["W"][:, 0], torch.arange(4.0, 8.0))


def _jax_hlo_census():
    """The JAX package's Trainer on ``dryrun_multichip``'s problem and its
    ``2x2`` mesh (``model_min_rows=8``): the collectives of each CG while
    body in the compiled epoch, and the epoch's totals."""
    import tempfile

    from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset
    from one_class_ffm_tpu.train import TrainConfig, Trainer

    with tempfile.TemporaryDirectory() as td:
        item, train, va = write_dataset(
            td, SynthSpec(n_users=64, n_items=32, avg_pos=4.0, seed=0,
                          dims_u=(64, 24), dims_v=(32, 16)))
        tr = Trainer(TrainConfig(item_path=item, train_path=train,
                                 test_path=va, k=8, lam=0.01, omega=0.1,
                                 nr_pass=1, eval_every=1, mesh_shape="2x2",
                                 model_min_rows=8))
        tr.init_state()
        s = tr.solver
        txt = s._epoch.lower(tr.state, s.data).compile().as_text()
    coll = re.compile(r"(all-reduce|all-gather|all-to-all|"
                      r"collective-permute|reduce-scatter)\(")
    bodies = set(re.findall(r"body=%?([\w.\-]+)", txt))
    comp, cur = {}, None
    for line in txt.splitlines():
        ls = line.strip()
        if ls.endswith("{") and not ls.startswith("//"):
            cur = ls.split()[0].lstrip("%")
            comp[cur] = []
        elif ls == "}":
            cur = None
        elif cur is not None:
            m = coll.search(ls)
            if m:
                comp[cur].append(m.group(1))
    per_body = Counter(tuple(sorted(Counter(comp.get(b, [])).items()))
                       for b in bodies)
    totals = Counter(c for v in comp.values() for c in v)
    return 2 * len(s.blocks), len(bodies), per_body, totals


def test_jax_2d_hlo_census():
    """The JAX package's own 2-D census, for PERF.md beside the port's: one
    CG while body per half-solve, none with an all-gather.  (GSPMD's
    choice inside the bodies, all-reduces and collective-permutes of the
    model-sharded tables, is printed; the port does not copy it.)"""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    halves, n_bodies, per_body, totals = _jax_hlo_census()
    print(f"JAX 2x2 HLO census: {n_bodies} CG bodies for {halves} "
          f"half-solves; per body {dict(per_body)}; epoch totals "
          f"{dict(totals)}")
    assert n_bodies == halves
    assert not any(dict(k).get("all-gather") for k in per_body)


# ---------------------------------------------------------------------------
# the Trainer and the command line on --mesh 2x2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    d = tmp_path_factory.mktemp("mesh2d_data")
    return write_dataset(str(d), SynthSpec(n_users=150, n_items=50,
                                           avg_pos=6.0, seed=7))


def _cfg(dataset, **kw):
    item, train, va = dataset
    return dict(item_path=item, train_path=train, test_path=va, k=4,
                nr_pass=3, eval_every=3, dtype="float64", blocked_bm=8,
                eval_chunk=16, **kw)


def test_trainer_2x2_matches_one_process(dataset, tmp_path):
    """``Trainer`` with ``mesh_shape="2x2"`` on 4 ranks (tables of at least
    16 rows row-sharded on the model axis): the log rows, CG counts,
    metrics, tables (true dims) and top-7 ids equal one process's; rank 0
    alone writes."""
    sys.path.insert(0, TESTS)
    import torch_mesh_worker

    ref = torch_mesh_worker.trainer_run(_cfg(dataset, row_multiple=16), 7)
    outs = spawn("torch_mesh_worker:trainer_run", 4,
                 args=(_cfg(dataset, mesh_shape="2x2", distributed=True,
                            model_min_rows=16), 7),
                 workdir=str(tmp_path))
    for r, got in enumerate(outs):
        assert got["size"] == 2 and got["writer"] == (r == 0)
        assert got["a_rows"] == got["m"] // 2
        assert got["rows"] == ref["rows"] and got["iters"] == ref["iters"]
        for key, val in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], val, rtol=1e-9,
                                       err_msg=key)
        for f12, blk in ref["params"].items():
            for name in ("W", "H"):
                assert got["params"][f12][name].shape == blk[name].shape
                np.testing.assert_allclose(got["params"][f12][name],
                                           blk[name], rtol=1e-9, atol=1e-11)
        np.testing.assert_array_equal(got["top"], ref["top"])


def test_cli_2x2_under_torchrun_environment(dataset, tmp_path, capsys):
    """``python -m one_class_ffm_torch ... --mesh 2x2 --model-min-rows 16
    --distributed`` started as torchrun starts it: rank 0 prints one
    process's rows and writes a model of true dims equal to one process's
    model; the other ranks print nothing."""
    from one_class_ffm_torch import cli
    from one_class_ffm_torch.train import load_text_model
    from test_torch_multihost import _torchrun

    item, train, va = dataset
    argv = [item, train, "-p", va, "-k", "4", "-t", "2", "--eval-every",
            "2", "--platform", "cpu", "--dtype", "float64", "--blocked-bm",
            "8", "--eval-chunk", "16"]
    ref_model = str(tmp_path / "one.txt")
    assert cli.main(argv + ["-o", ref_model]) == 0
    ref = capsys.readouterr().out
    model = str(tmp_path / "mesh.txt")
    outs = _torchrun(["-m", "one_class_ffm_torch", *argv, "--mesh", "2x2",
                      "--model-min-rows", "16", "--distributed", "-o",
                      model], 4)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{err[-3000:]}"
    assert outs[0][1] == ref
    assert all(out == "" for _, out, _ in outs[1:])
    lay_r, k_r, p_r = load_text_model(ref_model)
    lay_m, k_m, p_m = load_text_model(model)
    assert (k_m, lay_m.Du, lay_m.Dv) == (k_r, lay_r.Du, lay_r.Dv)
    for f12, blk in p_r.items():
        for name in ("W", "H"):
            np.testing.assert_allclose(p_m[f12][name], blk[name],
                                       rtol=1e-5, atol=1e-6)


def test_chip_smoke_mesh_2d_rehearsed_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """``[mesh ffm-2d]`` at toy size on the CPU: the FFM on the 2x2 mesh
    (4 ranks, tables of 512 rows or more row-sharded on the model axis)
    after ``[mesh ffm]`` on the same problem, rank 0's model file after
    the epochs equal to the 2-rank data mesh's, the sharded checkpoint
    after epoch 1 resumed on the mesh and restored on one process, every
    check but the kernels'."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "MESH_CHECK_USERS", 200)
    size = dict(n_users=600, n_items=300,
                dims=dict(dims_u=(600, 12), dims_v=(300, 8)))
    report = chip_smoke.new_report()
    for spec in (dict(chip_smoke.MESH_SPEC, **size),
                 dict(chip_smoke.MESH_PATHS["2d"], **size,
                      trainer=dict(model_min_rows=512))):
        got = chip_smoke.mesh_phase(torch.device("cpu"), "cpu", report,
                                    spec)
        assert not any(got.values())
    out = capsys.readouterr().out
    assert out.count("[mesh ffm-2d] rank 1.1 epoch 2") == 2
    assert "rank 0.0 model file after epoch 2" in out
    assert "against [mesh ffm] rank 0's file 0.000e+00" in out
    assert "'W[0]': (300, 32)" in out  # the user id table, half its rows
    # the sharded checkpoint after epoch 1, resumed on the 2x2 mesh
    assert out.count("sharded checkpoint after epoch 1") == 4
    assert "census of both saves []" in out
    assert "one-process restore (no mesh) of the checkpoint: epoch 1" in out
