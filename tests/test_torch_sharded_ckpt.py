"""The port's sharded-native checkpoints (``--ckpt-format orbax``,
``one_class_ffm_torch/utils/sharded_ckpt.py`` on
``torch.distributed.checkpoint``), the counterpart of the JAX package's
``utils/orbax_ckpt.py``.

One process, a 2-rank data mesh and the 2x2 ``data x model`` mesh (gloo
ranks, ``tests/torch_mesh_worker.py``; tables of at least 16 rows
row-sharded on the model axis, the id tables of 149 users and 51 items
padded to 150 and 52 there) each train 2 epochs of an FFM with self
blocks at float64 and save; each resumes its own checkpoint and the
others' to epoch 4.  A restore gives the saved tables bit for bit on every
topology; a resume on the writer's topology equals its unbroken run at
rtol 1e-12 / atol 1e-15 (the npz resume's tolerance); on another topology
the one-process run at rtol 1e-9 / atol 1e-11 (the 2x2 mesh's own
tolerance, ``test_torch_mesh_2d.py``).  On the 2x2 mesh each rank writes
only its own rows of a row-sharded table and the save makes no
collective of the mesh (its census).  Against the JAX package: the same
init model through its orbax save and resume and the port's sharded save
and resume give tables within 1e-9."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from one_class_ffm_torch import cli as torch_cli
from one_class_ffm_torch.data.synth import SynthSpec, write_dataset
from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.train import TrainConfig, Trainer
from one_class_ffm_torch.utils import sharded_ckpt

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
RESUME = dict(rtol=1e-12, atol=1e-15)  # test_trainer_checkpoint_resume...
MESH = dict(rtol=1e-9, atol=1e-11)  # test_trainer_2x2_matches_one_process


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ckpt_data")
    return write_dataset(str(d), SynthSpec(n_users=149, n_items=51,
                                           avg_pos=6.0, seed=7))


def _kw(dataset, **kw):
    item, train, va = dataset
    return dict(item_path=item, train_path=train, test_path=va, k=4,
                eval_every=2, dtype="float64", blocked_bm=8, eval_chunk=16,
                row_multiple=16, **kw)


def _trainer(dataset, **kw):
    return Trainer(TrainConfig(**_kw(dataset, **kw)), device="cpu")


def _assert_tables(got, want, exact=False, tol=RESUME):
    assert sorted(got) == sorted(want)
    for f12, blk in want.items():
        for name in ("W", "H"):
            assert got[f12][name].shape == blk[name].shape
            if exact:
                np.testing.assert_array_equal(got[f12][name], blk[name])
            else:
                np.testing.assert_allclose(got[f12][name], blk[name], **tol)


# ---------------------------------------------------------------------------
# (a) the module on one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_one_process_round_trip_is_bit_equal(tmp_path, dtype):
    """Tables at padded dims (zero pad rows) and storage dtype come back
    bit for bit, with the original's meta keys and step directory."""
    gen = torch.Generator().manual_seed(3)

    def table(rows, pad):
        t = torch.rand((rows, 4), generator=gen, dtype=torch.float64) - 0.5
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).to(dtype)

    params = {0: dict(W=table(7, 1), H=table(5, 1)),
              3: dict(W=table(5, 1), H=table(16, 0))}
    ck = str(tmp_path / "ck")
    layout = dict(fu=2, fv=2, Du=[7, 5], Dv=[5, 16], self_side=True)
    nbytes = sharded_ckpt.save(ck, params, 3, meta=dict(k=4, layout=layout))
    assert nbytes >= sum(t.numel() * t.element_size()
                         for blk in params.values() for t in blk.values())
    assert sharded_ckpt.has_checkpoint(ck)
    assert os.path.isdir(os.path.join(ck, "step_3"))
    meta = sharded_ckpt.read_meta(ck)
    assert meta == dict(epoch=3, step_dir="step_3", k=4, layout=layout,
                        format="torch.distributed.checkpoint")
    got, epoch = sharded_ckpt.load(ck)
    assert epoch == 3 and sorted(got) == sorted(params)
    for f12, blk in params.items():
        for name, t in blk.items():
            assert got[f12][name].dtype == dtype
            assert torch.equal(got[f12][name], t)


# ---------------------------------------------------------------------------
# (b) the Trainer on one process: the JAX package's
# test_orbax_checkpoint_resume
# ---------------------------------------------------------------------------


def test_trainer_sharded_resume_matches_straight_run(dataset, tmp_path):
    ck = str(tmp_path / "ck")
    first = _trainer(dataset, nr_pass=4, ckpt_dir=ck, ckpt_format="orbax")
    first.run(log=lambda *_: None)
    assert sharded_ckpt.has_checkpoint(ck)
    assert sharded_ckpt.read_meta(ck)["epoch"] == 4
    assert sorted(os.listdir(ck)) == [sharded_ckpt.META, "step_2", "step_4"]
    assert [s["epoch"] for s in first.ckpt_stats] == [2, 4, 4]
    resumed = _trainer(dataset, nr_pass=6, ckpt_dir=ck, ckpt_format="orbax",
                       resume=True)
    resumed.init_state()
    assert resumed.epoch_idx == 4
    _assert_tables(resumed.params_numpy(), first.params_numpy(), exact=True)
    resumed.run(log=lambda *_: None)
    straight = _trainer(dataset, nr_pass=6)
    straight.run(log=lambda *_: None)
    _assert_tables(resumed.params_numpy(), straight.params_numpy())


# ---------------------------------------------------------------------------
# (c), (d): the three topologies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def topologies(dataset, tmp_path_factory):
    """One process writes ``one``; 4 ranks write ``data4`` (a 4-rank data
    mesh), then ``2x2`` (resuming ``one`` and ``data4``); 2 ranks write
    ``data`` (resuming ``one`` and ``2x2``); one process resumes ``2x2``
    and ``data``.  Each run: 2 epochs and a save, a resume of its own
    checkpoint to 4, the unbroken run to 4."""
    work = tmp_path_factory.mktemp("sharded_ckpt")
    ck = {name: str(work / f"ck_{name}")
          for name in ("one", "data4", "2x2", "data")}
    first = _trainer(dataset, nr_pass=2, ckpt_dir=ck["one"],
                     ckpt_format="orbax")
    first.run(log=lambda *_: None)
    straight = _trainer(dataset, nr_pass=4)
    straight.run(log=lambda *_: None)
    out = dict(ck=ck, one=dict(saved=first.params_numpy(),
                               straight=straight.params_numpy()))
    sys.path.insert(0, TESTS)
    mesh = dict(distributed=True, model_min_rows=16)
    d4 = spawn("torch_mesh_worker:sharded_ckpt_run", 4,
               args=(_kw(dataset, mesh_shape="4", **mesh), ck["data4"],
                     dict(one=ck["one"])), workdir=str(work / "d4"))
    out["data4"] = d4
    out["2x2"] = spawn("torch_mesh_worker:sharded_ckpt_run", 4,
                       args=(_kw(dataset, mesh_shape="2x2", **mesh),
                             ck["2x2"], dict(one=ck["one"],
                                             data4=ck["data4"])),
                       workdir=str(work / "m22"))
    out["data"] = spawn("torch_mesh_worker:sharded_ckpt_run", 2,
                        args=(_kw(dataset, mesh_shape="2", **mesh),
                              ck["data"], dict(one=ck["one"],
                                               **{"2x2": ck["2x2"]})),
                        workdir=str(work / "d2"))
    out["one"]["froms"] = {}
    for name in ("2x2", "data"):
        tr = _trainer(dataset, nr_pass=4, ckpt_dir=ck[name],
                      ckpt_format="orbax", resume=True)
        tr.init_state()
        got = dict(epoch=tr.epoch_idx, loaded=tr.params_numpy())
        tr.cfg = dataclasses.replace(tr.cfg, ckpt_dir=None)
        tr.run(log=lambda *_: None)
        got["final"] = tr.params_numpy()
        out["one"]["froms"][name] = got
    return out


def test_2x2_each_rank_writes_its_own_rows(topologies):
    """DCP's metadata of the 2x2 checkpoint (``chip_smoke.ckpt_files``, which
    fails otherwise): a row-sharded table is two row blocks, each in the
    file of a rank of its model index; a replicated table one block,
    written once; no rank holds or writes a whole row-sharded table."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import chip_smoke

    outs = topologies["2x2"]
    specs = outs[0]["specs"]
    sharded = [(f12, n) for f12, blk in specs.items()
               for n, (_, sh) in blk.items() if sh]
    assert sharded, "no table is row-sharded"
    model_of = {o["world"]: o["model_rank"] for o in outs}
    files = chip_smoke.ckpt_files(topologies["ck"]["2x2"], specs, model_of)
    for f12, blk in specs.items():
        for name, (rows, sh) in blk.items():
            blocks = files[f"{name}[{f12}]"]
            assert len(blocks) == (2 if sh else 1)
            assert sum(n for _, n, _ in blocks) == rows
    for o in outs:
        for f12, name in sharded:
            held = o["held"][f12][name]
            assert held.shape[0] == specs[f12][name][0] // 2
        assert [s["op"] for s in o["stats"]] == ["save", "save"]


def test_2x2_save_makes_no_collective_of_the_mesh(topologies):
    """The census of every save on every rank: no model-axis all-gather,
    no collective at all (DCP coordinates its plans itself)."""
    for o in topologies["2x2"]:
        assert len(o["saves"]) == 2
        for rows in o["saves"]:
            assert not [r for r in rows if r[0].startswith("all_gather")]
            assert rows == []


@pytest.mark.parametrize("topology", ["one", "data4", "2x2", "data"])
def test_resume_on_the_writer_topology_equals_the_unbroken_run(topologies,
                                                               topology):
    """The restore gives the saved tables bit for bit (the ranks' held
    rows too); trained on to epoch 4 the unbroken run's tables."""
    if topology == "one":
        return _one_process_resume(topologies)
    for o in topologies[topology]:
        got = o["resumed"]
        assert got["epoch"] == 2
        _assert_tables(got["loaded"], o["saved"], exact=True)
        _assert_tables(got["held"], o["held"], exact=True)
        _assert_tables(got["final"], o["straight"])


def _one_process_resume(topologies):
    ck = topologies["ck"]["one"]
    got, epoch = sharded_ckpt.load(ck)
    assert epoch == 2
    saved = topologies["one"]["saved"]
    for f12, blk in saved.items():
        for name, t in blk.items():
            np.testing.assert_array_equal(
                got[f12][name][: t.shape[0]].numpy(), t)


@pytest.mark.parametrize("writer, reader", [
    ("one", "2x2"), ("one", "data"), ("one", "data4"), ("2x2", "one"),
    ("2x2", "data"), ("data", "one"), ("data4", "2x2")])
def test_topology_changes_restore_identical_tables(topologies, writer,
                                                   reader):
    """A checkpoint written on one topology restores on another to the
    writer's tables bit for bit (true dims; each rank its own rows); the
    run resumed from it to epoch 4 equals the one-process unbroken run at
    the mesh's tolerance."""
    saved = (topologies["one"]["saved"] if writer == "one"
             else topologies[writer][0]["saved"])
    readers = ([topologies["one"]] if reader == "one"
               else topologies[reader])
    for o in readers:
        got = o["froms"][writer]
        assert got["epoch"] == 2
        _assert_tables(got["loaded"], saved, exact=True)
        _assert_tables(got["final"], topologies["one"]["straight"],
                       tol=MESH)


def test_2x2_padded_tables_match_one_process(topologies):
    """The 2x2 mesh pads the id tables of 149 users and 51 items to 150
    and 52 rows: its unbroken run equals the one process's at the mesh's
    tolerance and the pad rows stay exactly zero (an identity field's
    gradient and Hv keep the data's pad rows out of them)."""
    assert topologies["2x2"][0]["specs"][0]["W"] == (150, True)
    for o in topologies["2x2"]:
        assert o["pad_max"] == 0.0
        _assert_tables(o["straight"], topologies["one"]["straight"],
                       tol=MESH)


# ---------------------------------------------------------------------------
# (e) against the JAX package's orbax checkpoints
# ---------------------------------------------------------------------------


def test_sharded_resume_matches_the_jax_orbax_resume(dataset, tmp_path):
    """The JAX package's test_orbax_checkpoint_resume and the port's
    counterpart from one JAX-written init model: 4 epochs, a save, a
    resume to 6; the resumed tables agree within 1e-9 at float64."""
    from one_class_ffm_tpu import cli as jax_cli
    from one_class_ffm_tpu.train import TrainConfig as JaxConfig
    from one_class_ffm_tpu.train import Trainer as JaxTrainer
    from one_class_ffm_tpu.utils import orbax_ckpt

    if not orbax_ckpt.available():
        pytest.skip("orbax not installed")
    item, train, va = dataset
    model = str(tmp_path / "init.txt")
    assert jax_cli.main([item, train, "-k", "4", "-t", "0", "--platform",
                         "cpu", "--dtype", "float64", "-o", model]) == 0
    base = dict(item_path=item, train_path=train, test_path=va, k=4,
                eval_every=2, dtype="float64", init_model=model,
                eval_chunk=16, ckpt_format="orbax")
    tables = {}
    for name, cfg_cls, make in (
            ("jax", JaxConfig, lambda c: JaxTrainer(c)),
            ("port", TrainConfig, lambda c: Trainer(c, device="cpu"))):
        ck = str(tmp_path / f"ck_{name}")
        first = make(cfg_cls(nr_pass=4, ckpt_dir=ck, **base))
        first.init_state()
        first.run(log=lambda *_: None)
        resumed = make(cfg_cls(nr_pass=6, ckpt_dir=ck, resume=True, **base))
        resumed.init_state()
        assert resumed.epoch_idx == 4
        resumed.run(log=lambda *_: None)
        tables[name] = resumed.params_numpy()
    assert orbax_ckpt.has_checkpoint(str(tmp_path / "ck_jax"))
    assert sharded_ckpt.has_checkpoint(str(tmp_path / "ck_port"))
    for f12, blk in tables["jax"].items():
        for name in ("W", "H"):
            np.testing.assert_allclose(tables["port"][f12][name], blk[name],
                                       rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# (f) the command line
# ---------------------------------------------------------------------------


def _cli(dataset, *extra):
    item, train, va = dataset
    return torch_cli.main([item, train, "-p", va, "-k", "4", "--platform",
                           "cpu", "--dtype", "float64", "--eval-every", "2",
                           "--eval-chunk", "16", *extra])


def test_cli_orbax_resume_trains(dataset, tmp_path, capsys):
    """``--ckpt-format orbax``: a 2-epoch run, then ``-t 4 --resume``; the
    resumed run prints the unbroken run's last row and writes its model."""
    from one_class_ffm_torch.train import load_text_model

    ck = str(tmp_path / "ck")
    assert _cli(dataset, "-t", "2", "--ckpt", ck, "--ckpt-format",
                "orbax") == 0
    assert sharded_ckpt.read_meta(ck)["epoch"] == 2
    capsys.readouterr()
    out_model = str(tmp_path / "resumed.txt")
    assert _cli(dataset, "-t", "4", "--ckpt", ck, "--ckpt-format", "orbax",
                "--resume", "-o", out_model) == 0
    resumed_rows = capsys.readouterr().out.splitlines()
    ref_model = str(tmp_path / "straight.txt")
    assert _cli(dataset, "-t", "4", "-o", ref_model) == 0
    straight_rows = capsys.readouterr().out.splitlines()
    assert resumed_rows[-1] == straight_rows[-1]
    assert sharded_ckpt.read_meta(ck)["epoch"] == 4
    _, _, got = load_text_model(out_model)
    _, _, want = load_text_model(ref_model)
    _assert_tables(got, want, tol=dict(rtol=2e-5, atol=1e-7))


def test_cli_refuses_a_jax_orbax_checkpoint(dataset, tmp_path, capsys):
    """A directory of the JAX package's orbax checkpoint (and none of the
    port's): ``--resume`` fails naming the format, and trains nothing."""
    from one_class_ffm_tpu.utils import orbax_ckpt

    if not orbax_ckpt.available():
        pytest.skip("orbax not installed")
    ck = str(tmp_path / "jax_ck")
    params = {0: dict(W=np.zeros((149, 4)), H=np.zeros((51, 4)))}
    orbax_ckpt.save(ck, params, 2, meta=dict(k=4))
    assert orbax_ckpt.has_checkpoint(ck)
    rc = _cli(dataset, "-t", "4", "--ckpt", ck, "--ckpt-format", "orbax",
              "--resume")
    assert rc == 1
    err = capsys.readouterr().err
    for want in ("orbax", "JAX package", "torch.distributed.checkpoint"):
        assert want in err
    assert not sharded_ckpt.has_checkpoint(ck)
    with open(os.path.join(ck, sharded_ckpt.JAX_META)) as fh:
        assert json.load(fh)["epoch"] == 2
