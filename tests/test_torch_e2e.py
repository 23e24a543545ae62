"""End to end: the port's command line and trainer against the JAX ones on
tiny MF, FFM and FM text datasets, each from one warm-start model."""

import json

import numpy as np
import pytest
import torch

from one_class_ffm_tpu import cli as jax_cli
from one_class_ffm_tpu.data.synth import (
    SynthSpec,
    _write_rows,
    generate,
    write_dataset,
)
from one_class_ffm_tpu.train import TrainConfig, load_text_model
from one_class_ffm_torch import cli as torch_cli
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.train import Trainer
from test_torch_copies import _flatten

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mf_set(tmp_path_factory):
    """MF text files (one id field per side) and a random text model."""
    out = tmp_path_factory.mktemp("mf")
    item, train, va = write_dataset(
        str(out), SynthSpec(n_users=90, n_items=30, fu=1, fv=1, avg_pos=5.0,
                            seed=5))
    model = str(out / "model.txt")
    assert jax_cli.main([item, train, "--ns", "-k", "4", "-t", "0",
                         "--platform", "cpu", "--dtype", "float64",
                         "-o", model]) == 0
    return item, train, va, model


@pytest.fixture(scope="module")
def ffm_set(tmp_path_factory):
    """FFM text files (an id field and a small feature field per side) and
    a random text model with self blocks."""
    out = tmp_path_factory.mktemp("ffm")
    item, train, va = write_dataset(
        str(out), SynthSpec(n_users=90, n_items=30, avg_pos=5.0, seed=6))
    model = str(out / "model.txt")
    assert jax_cli.main([item, train, "-k", "4", "-t", "0", "--platform",
                         "cpu", "--dtype", "float64", "-o", model]) == 0
    return item, train, va, model


def _run(main, data_set, tmp_path, capsys, tag, extra=("--ns",)):
    item, train, va, model = data_set
    jsonl = tmp_path / f"{tag}.jsonl"
    rc = main([item, train, "-p", va, "-k", "4", "-t", "4",
               "--eval-every", "2", "--platform", "cpu", "--dtype",
               "float64", "--init-model", model, "--jsonl", str(jsonl),
               "--predict-topk", "3", "--eval-chunk", "16", *extra])
    out = capsys.readouterr().out
    assert rc == 0
    return out, [json.loads(ln) for ln in jsonl.read_text().splitlines()]


def test_cli_rows_match_jax(mf_set, tmp_path, capsys):
    """Same header, log rows and top-K ids, byte for byte."""
    ref_out, ref_js = _run(jax_cli.main, mf_set, tmp_path, capsys, "jax")
    got_out, got_js = _run(torch_cli.main, mf_set, tmp_path, capsys, "torch")
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    assert [r["epoch"] for r in got_js] == [2, 4]
    for a, b in zip(got_js, ref_js):
        assert set(a) == set(b)
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)


def test_cli_ffm_rows_match_jax(ffm_set, tmp_path, capsys):
    """FFM without --ns (self blocks; the feature fields take the fused
    table passes): same header, log rows and top-K ids as the JAX CLI."""
    ref_out, ref_js = _run(jax_cli.main, ffm_set, tmp_path, capsys, "jax",
                           extra=())
    got_out, got_js = _run(torch_cli.main, ffm_set, tmp_path, capsys,
                           "torch", extra=())
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)


def test_cli_ffm_freq_rows_match_jax(ffm_set, tmp_path, capsys):
    """FFM with --freq (frequency-weighted lambda, the ffm-freq variant of
    the parity harness): the same header, log rows and top-K ids as the JAX
    CLI from the same model."""
    ref_out, ref_js = _run(jax_cli.main, ffm_set, tmp_path, capsys, "jax",
                           extra=("--freq",))
    got_out, got_js = _run(torch_cli.main, ffm_set, tmp_path, capsys,
                           "torch", extra=("--freq",))
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)


@pytest.fixture(scope="module")
def fm_set(tmp_path_factory):
    """FM text files (one field per side: the id and the feature columns,
    140 and 60 features), split as write_dataset splits, and a random text
    model with self blocks and one without."""
    out = tmp_path_factory.mktemp("fm")
    spec = SynthSpec(n_users=90, n_items=30, avg_pos=5.0, seed=7)
    du, dv = spec.resolve()
    users, items = generate(spec)
    rng = np.random.default_rng(spec.seed + 1)
    tr_rows, va_rows = [], []
    for labels, feats in _flatten(users, du):
        labels = list(labels)
        rng.shuffle(labels)
        n_va = min(int(len(labels) * 0.2), len(labels) - 1)
        tr_rows.append((sorted(labels[n_va:]), feats))
        if n_va > 0:
            va_rows.append((sorted(labels[:n_va]), feats))
    item, train, va = (str(out / n) for n in ("items.fm", "train.fm",
                                               "va.fm"))
    _write_rows(item, _flatten(items, dv), with_labels=False)
    _write_rows(train, tr_rows, with_labels=True)
    _write_rows(va, va_rows, with_labels=True)
    models = {}
    for tag, flags in (("self", []), ("ns", ["--ns"])):
        models[tag] = str(out / f"model_{tag}.txt")
        assert jax_cli.main([item, train, *flags, "-k", "4", "-t", "0",
                             "--platform", "cpu", "--dtype", "float64",
                             "-o", models[tag]]) == 0
    return item, train, va, models


@pytest.mark.parametrize("extra", [(), ("--ns",)], ids=["self", "ns"])
def test_cli_fm_rows_match_jax(fm_set, tmp_path, capsys, monkeypatch, extra):
    """FM with and without self blocks, its fields (140 and 60 features)
    above a lowered fused-table cap, so the port projects with B8 and
    scatters with the X^T stage: same header, log rows and top-K ids as
    the JAX CLI, byte for byte."""
    monkeypatch.setattr(torch_solver, "FUSED_TBL_D", 8)
    monkeypatch.setenv("OCFFM_FUSED_TBL_D", "8")
    item, train, va, models = fm_set
    data_set = (item, train, va, models["ns" if extra else "self"])
    ref_out, ref_js = _run(jax_cli.main, data_set, tmp_path, capsys, "jax",
                           extra=extra)
    got_out, got_js = _run(torch_cli.main, data_set, tmp_path, capsys,
                           "torch", extra=extra)
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)
    trainer = Trainer(TrainConfig(item_path=item, train_path=train, k=4,
                                  dtype="float64",
                                  self_side=not extra), device="cpu")
    meta = trainer.meta
    assert trainer.data.layout.Du == (140,) and trainer.data.layout.Dv == (60,)
    assert meta.fused_u == (False,) and meta.fused_v == (False,)
    assert meta.ident_u == (False,) and meta.ident_v == (False,)


@pytest.mark.parametrize("tag, extra", [
    ("mf", ("--ns", "--blocked-bm", "0")),
    ("ffm", ("--blocked-bm", "0")),
], ids=["mf-ns", "ffm"])
def test_cli_coo_rows_match_jax(mf_set, ffm_set, tmp_path, capsys, tag,
                                extra):
    """``--blocked-bm 0``: both sides take the plain COO positive passes
    (on the FFM its feature fields the general scatter, not the fused
    passes), and the log rows, header and top-K ids equal the JAX CLI's
    with the same flag, byte for byte."""
    data_set = mf_set if tag == "mf" else ffm_set
    ref_out, ref_js = _run(jax_cli.main, data_set, tmp_path, capsys, "jax",
                           extra=extra)
    got_out, got_js = _run(torch_cli.main, data_set, tmp_path, capsys,
                           "torch", extra=extra)
    assert got_out == ref_out
    assert len(got_out.splitlines()) > 3
    for a, b in zip(got_js, ref_js):
        for key in ("p@5", "ndcg@10", "ploss", "auc"):
            assert a[key] == pytest.approx(b[key], rel=1e-9)
    item, train, _, _ = data_set
    trainer = Trainer(TrainConfig(item_path=item, train_path=train, k=4,
                                  dtype="float64", blocked_bm=0,
                                  self_side="--ns" not in extra),
                      device="cpu")
    meta = trainer.meta
    assert (meta.blocked_bm_u, meta.blocked_bm_v) == (0, 0)
    assert not any(meta.fused_u + meta.fused_v)
    assert "coo_u" in trainer.solver.data and "coo_v" in trainer.solver.data


# models without --ns, --cg-precond jacobi (test_torch_jacobi.py),
# --blocked-bm 0 (test_cli_coo_rows_match_jax), --profile-dir
# (test_cli_profile_dir_writes_a_trace) and --mesh N / NxM --distributed
# under torchrun (test_torch_multihost.py, test_torch_mesh_2d.py) and
# --ckpt-format orbax (test_torch_sharded_ckpt.py) run now; a mesh the
# run's ranks cannot form names the launch that can
# what each refusal must say, by the case's option
REFUSALS = {
    "--mesh": ("--mesh 2 needs 2 ranks", "torchrun --nproc-per-node 2"),
    "--distributed": ("--mesh 2x2 needs 4 ranks",
                      "torchrun --nproc-per-node 4"),
}


@pytest.mark.parametrize("argv, message", [
    (["--ns", "--mesh", "2"], "--mesh"),
    (["--ns", "--distributed", "--mesh", "2x2"], "--distributed"),
])
def test_cli_refuses_what_the_port_lacks(mf_set, capsys, argv, message):
    item, train, _, _ = mf_set
    rc = torch_cli.main([item, train, "--platform", "cpu", *argv])
    assert rc == 1
    err = capsys.readouterr().err
    for want in REFUSALS[message]:
        assert want in err


def test_cli_profile_dir_writes_a_trace(mf_set, tmp_path, capsys):
    """--profile-dir traces the epochs with torch.profiler (host operators
    on the CPU) into a Chrome trace, and trains as without it."""
    import glob

    item, train, va, model = mf_set
    argv = [item, train, "-p", va, "--ns", "-k", "4", "-t", "2",
            "--eval-every", "2", "--platform", "cpu", "--dtype", "float64",
            "--init-model", model, "--eval-chunk", "16"]
    trace_dir = tmp_path / "trace"
    assert torch_cli.main(argv + ["--profile-dir", str(trace_dir)]) == 0
    traced = capsys.readouterr().out
    assert torch_cli.main(argv) == 0
    assert traced == capsys.readouterr().out
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(str(n).startswith("aten::") for n in names)


def test_trace_profile_is_a_no_op_without_a_directory(tmp_path,
                                                      monkeypatch):
    from one_class_ffm_torch.utils.profiling import trace_profile

    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace_profile(log_dir, "cpu"):
            torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_cli_refuses_a_missing_gpu(mf_set, capsys):
    """--platform defaults to cuda; without a GPU that is an error, never a
    quiet switch to the CPU."""
    item, train, _, _ = mf_set
    with pytest.raises(SystemExit) as exc:
        torch_cli.main([item, train, "--ns"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_trainer_checkpoint_resume_and_model_file(mf_set, tmp_path):
    item, train, va, model = mf_set
    base = dict(item_path=item, train_path=train, test_path=va, k=4,
                self_side=False, dtype="float64", init_model=model,
                eval_every=2, eval_chunk=16)
    straight = Trainer(TrainConfig(nr_pass=4, **base), device="cpu")
    straight.run(log=lambda *_: None)
    ck = str(tmp_path / "ck")
    first = Trainer(TrainConfig(nr_pass=2, ckpt_dir=ck, **base),
                    device="cpu")
    first.run(log=lambda *_: None)
    resumed = Trainer(TrainConfig(nr_pass=4, ckpt_dir=ck, resume=True,
                                  model_path=str(tmp_path / "out.txt"),
                                  **base), device="cpu")
    resumed.run(log=lambda *_: None)
    assert resumed.epoch_idx == 4
    ref = straight.params_numpy()
    for f12, blk in resumed.params_numpy().items():
        for name in ("W", "H"):
            np.testing.assert_allclose(blk[name], ref[f12][name],
                                       rtol=1e-12, atol=1e-15)
    _, k, saved = load_text_model(str(tmp_path / "out.txt"))
    assert k == 4
    for f12, blk in saved.items():
        np.testing.assert_allclose(blk["W"], ref[f12]["W"], rtol=2e-5,
                                   atol=1e-7)
    # refresh_every auto: off at float64
    assert resumed.refresh_every == 0
    assert resumed.dtype == torch.float64
