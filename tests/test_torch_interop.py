"""The JAX package's interop holds (``tests/test_interop.py``) on the port:
the text model format and warm starts, the port's own model, a model of
another k, and a model written by the committed C++ reference binary.

Each case runs the port's Trainer (on the CPU, float64) and the JAX
Trainer on the same files with the same ``TrainConfig`` from the same
model: their log rows must be equal, their metrics and tables equal at
rtol 1e-9 and the model files they write equal byte for byte."""

import os
import subprocess

import numpy as np
import pytest
import torch

from one_class_ffm_tpu import train as jax_train
from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset
from one_class_ffm_torch import train as torch_train

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(REPO, "scripts", "ref_build", "train")
RTOL = 1e-9


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("interop")
    return write_dataset(
        str(out), SynthSpec(n_users=60, n_items=20, avg_pos=5.0, seed=13)
    )


@pytest.fixture(scope="module")
def init_model(dataset, tmp_path_factory):
    """A text model of the JAX Trainer's seeded initial tables (k=3)."""
    item, train, _ = dataset
    tr = jax_train.Trainer(jax_train.TrainConfig(
        item_path=item, train_path=train, k=3, dtype="float64"))
    tr.init_state()
    path = str(tmp_path_factory.mktemp("init") / "init.txt")
    jax_train.save_text_model(path, tr.params_numpy(), tr.data.layout, 3)
    return path


def run_both(tmp_path, **kw):
    """(port Trainer, JAX Trainer, their log rows, their model paths) after
    a run of each with ``TrainConfig(**kw)`` (a model path gets a suffix
    per package)."""
    out = []
    for tag, mod, extra in (("torch", torch_train, dict(device="cpu")),
                            ("jax", jax_train, {})):
        cfg = dict(kw)
        if cfg.get("model_path"):
            cfg["model_path"] = str(tmp_path / f"{tag}_{cfg['model_path']}")
        tr = mod.Trainer(mod.TrainConfig(**cfg), **extra)
        tr.init_state()
        rows = []
        tr.run(log=rows.append)
        out.append((tr, rows, cfg.get("model_path")))
    (got, got_rows, got_model), (ref, ref_rows, ref_model) = out
    assert got_rows == ref_rows
    if got.evaluator is not None:
        m_got, m_ref = got.validate(), ref.validate()
        assert set(m_got) == set(m_ref)
        for key, val in m_ref.items():
            np.testing.assert_allclose(m_got[key], val, rtol=RTOL,
                                       err_msg=key)
    p_got, p_ref = got.params_numpy(), ref.params_numpy()
    for f12, blk in p_ref.items():
        for name, tbl in blk.items():
            np.testing.assert_allclose(p_got[f12][name], tbl, rtol=RTOL,
                                       atol=1e-12, err_msg=f"{name}[{f12}]")
    if got_model:
        with open(got_model, "rb") as a, open(ref_model, "rb") as b:
            assert a.read() == b.read()
    return got, ref, got_model


def test_warm_start_from_own_model(dataset, init_model, tmp_path):
    item, train, va = dataset
    common = dict(item_path=item, train_path=train, test_path=va, k=3,
                  nr_pass=2, eval_every=2, dtype="float64", eval_chunk=32)
    tr, _, model = run_both(tmp_path, init_model=init_model,
                            model_path="m.txt", **common)
    m0 = tr.validate()
    # the port's own model: its metrics again before training, then on
    tr2, _, _ = run_both(tmp_path, init_model=model, **common)
    tr3 = torch_train.Trainer(torch_train.TrainConfig(
        init_model=model, **common), device="cpu")
    tr3.init_state()
    np.testing.assert_allclose(tr3.validate()["ploss"], m0["ploss"],
                               rtol=1e-3)
    assert np.isfinite(tr2.validate()["ploss"])


def test_warm_start_rejects_mismatched_k(dataset, init_model, tmp_path):
    item, train, _ = dataset
    _, _, model = run_both(tmp_path, item_path=item, train_path=train, k=3,
                           nr_pass=1, init_model=init_model,
                           model_path="m.txt", dtype="float64")
    for mod, extra in ((torch_train, dict(device="cpu")), (jax_train, {})):
        tr = mod.Trainer(mod.TrainConfig(
            item_path=item, train_path=train, k=5, nr_pass=1,
            init_model=model, dtype="float64"), **extra)
        with pytest.raises(ValueError, match="k=3"):
            tr.init_state()


@pytest.mark.skipif(not os.path.exists(REF_BIN), reason="reference not built")
def test_reference_saved_model_loads(dataset, tmp_path):
    """A model saved by the C++ reference binary parses into the port's
    layout as into the JAX package's, and warm-starts both Trainers alike."""
    item, train, va = dataset
    model = str(tmp_path / "ref_model.txt")
    subprocess.run(
        [REF_BIN, "-k", "3", "-l", "0.05", "-w", "0.1", "-r", "-1",
         "-t", "2", "-c", "2", "-o", model, item, train],
        check=True, capture_output=True,
    )
    layout, k, params = torch_train.load_text_model(model)
    j_layout, j_k, j_params = jax_train.load_text_model(model)
    assert k == j_k == 3
    assert layout.fu == 2 and layout.fv == 2
    assert (layout.Du, layout.Dv) == (j_layout.Du, j_layout.Dv)
    for b in layout.all_blocks():
        for name, rows in (("W", b.d1), ("H", b.d2)):
            assert params[b.f12][name].shape == (rows, 3)
            assert np.all(np.isfinite(params[b.f12][name]))
            np.testing.assert_array_equal(params[b.f12][name],
                                          j_params[b.f12][name])
    # and the port's Trainer warm-starts from it as the JAX one does
    run_both(tmp_path, item_path=item, train_path=train, test_path=va,
             k=3, nr_pass=1, eval_every=1, dtype="float64",
             init_model=model, eval_chunk=32)
