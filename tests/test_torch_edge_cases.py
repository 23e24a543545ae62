"""The JAX package's edge cases (``tests/test_edge_cases.py``) on the port:
degenerate shapes and sparse extremes through the whole stack at float64.

Each case writes the same text files, writes one warm-start model from the
JAX Trainer's seeded tables, and runs the port's Trainer (on the CPU) and
the JAX Trainer from it with the same ``TrainConfig``.  The port's log rows
must equal the JAX package's byte for byte, its metrics and tables must
match at rtol 1e-9, and the port must pass the JAX test's own checks."""

import math

import numpy as np
import pytest
import torch

from one_class_ffm_tpu import train as jax_train
from one_class_ffm_torch import train as torch_train

torch.set_num_threads(1)

RTOL = 1e-9


def write(tmp_path, items, train, va=None):
    ip = tmp_path / "items.ffm"
    tp = tmp_path / "train.ffm"
    ip.write_text(items)
    tp.write_text(train)
    vp = None
    if va is not None:
        vp = tmp_path / "va.ffm"
        vp.write_text(va)
    return str(ip), str(tp), (str(vp) if vp else None)


def _config(mod, item, train, va, **kw):
    return mod.TrainConfig(
        item_path=item, train_path=train, test_path=va,
        dtype="float64", eval_chunk=8, row_multiple=2,
        nr_pass=2, eval_every=2, **kw)


def _trained(trainer):
    rows = []
    trainer.init_state()
    trainer.run(log=rows.append)
    return trainer, rows


def run_both(tmp_path, item, train, va, **kw):
    """(port Trainer, JAX Trainer) after their runs from one model: the JAX
    Trainer's seeded initial tables, written as a text model."""
    init = jax_train.Trainer(_config(jax_train, item, train, va, **kw))
    init.init_state()
    model = str(tmp_path / "init.txt")
    jax_train.save_text_model(model, init.params_numpy(), init.data.layout,
                              init.cfg.k)
    ref, ref_rows = _trained(jax_train.Trainer(
        _config(jax_train, item, train, va, init_model=model, **kw)))
    got, got_rows = _trained(torch_train.Trainer(
        _config(torch_train, item, train, va, init_model=model, **kw),
        device="cpu"))
    assert got_rows == ref_rows
    m_got, m_ref = got.validate(), ref.validate()
    assert set(m_got) == set(m_ref)
    for key, val in m_ref.items():
        np.testing.assert_allclose(m_got[key], val, rtol=RTOL,
                                   equal_nan=True, err_msg=key)
    p_got, p_ref = got.params_numpy(), ref.params_numpy()
    for f12, blk in p_ref.items():
        for name, tbl in blk.items():
            np.testing.assert_allclose(p_got[f12][name], tbl, rtol=RTOL,
                                       atol=1e-12, err_msg=f"{name}[{f12}]")
    return got, m_got


def test_k1_rank_one(tmp_path):
    item, train, va = write(
        tmp_path,
        "0:0:1\n0:1:1\n0:2:1\n",
        "0,1 0:0:1\n2 0:1:1\n0 0:2:1\n",
        "2 0:0:1\n0 0:1:1\n",
    )
    _, m = run_both(tmp_path, item, train, va, k=1)
    assert np.isfinite(m["ploss"]) and 0 <= m["auc"] <= 1


def test_user_with_no_features(tmp_path):
    # second training row has labels but zero features (cold in training)
    item, train, va = write(
        tmp_path,
        "0:0:1\n0:1:1\n0:2:1\n",
        "0 0:0:1\n1,2\n2 0:1:1\n",
        "1\n0 0:1:1\n",
    )
    _, m = run_both(tmp_path, item, train, va, k=2)
    assert np.isfinite(m["ploss"])


def test_single_item_catalog(tmp_path):
    item, train, va = write(
        tmp_path,
        "0:0:1\n",
        "0 0:0:1\n0 0:1:1\n",
        "0 0:0:1\n",
    )
    _, m = run_both(tmp_path, item, train, va, k=2)
    # with one item every user hits it at rank 0
    assert m["p@5"] == pytest.approx(1.0 / 5)
    assert m["ndcg@5"] == pytest.approx(1.0)


def test_labels_beyond_item_file(tmp_path):
    # train labels reference item id 5 but the item file has 2 rows: the
    # pair is dropped from training, and eval keeps it in IDCG only
    item, train, va = write(
        tmp_path,
        "0:0:1\n0:1:1\n",
        "0,5 0:0:1\n1 0:1:1\n",
        "5,1 0:0:1\n",
    )
    _, m = run_both(tmp_path, item, train, va, k=2)
    assert np.isfinite(m["ploss"])
    assert m["ndcg@5"] <= 1.0


def test_all_test_users_cold(tmp_path):
    item, train, va = write(
        tmp_path,
        "0:0:1\n0:1:1\n0:2:1\n",
        "0 0:0:1\n1 0:1:1\n2,0 0:2:1\n",
        "1 0:9:1\n2 0:8:1\n",  # features unseen in train -> cold
    )
    _, m = run_both(tmp_path, item, train, va, k=2)
    # cold users rank by popularity; item 0 has 2 train clicks -> rank 0
    assert math.isfinite(m["auc"])
