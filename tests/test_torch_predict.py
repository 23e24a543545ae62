"""The port's predictor against the JAX one on the same model files.

Tiny MF --ns, FFM with self blocks and FM models are trained by the JAX
Trainer (float64) and saved as a text model and a checkpoint; the JAX
``predict_topk_from_model`` (CPU, ``project_xla``) and the port's
(``device="cpu"``, ``project_plain``) score the same user files.  Scores
agree within 1e-5 max-rel (float32); ids are equal wherever the ranking is
not decided by a near-tie (1e-5 relative), and exactly equal, the lowest id
first, on a model built of ties."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from one_class_ffm_tpu import predict as jax_predict
from one_class_ffm_tpu.data.synth import (
    SynthSpec,
    _write_rows,
    generate,
    write_dataset,
)
from one_class_ffm_tpu.train import TrainConfig as JaxConfig
from one_class_ffm_tpu.train import Trainer as JaxTrainer
from one_class_ffm_torch import predict as torch_predict
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.train import (
    TrainConfig,
    Trainer,
    save_checkpoint,
    save_text_model,
)
from test_torch_copies import _flatten

torch.set_num_threads(1)

TOL = 1e-5  # float32 scores, max-rel


def _users_file(path, va_path):
    """The test users' feature rows without labels, then two cold rows:
    one whose only feature is out of vocabulary, one empty."""
    with open(va_path) as fh:
        rows = [ln.split(None, 1)[1] if " " in ln.strip() else "\n"
                for ln in fh]
    with open(path, "w") as out:
        out.writelines(rows)
        out.write("0:999999:1\n\n")
    return path


def _fm_files(out, spec):
    """FM text files: the synthetic rows flattened into one field per side
    (scripts/parity_check.py's fm encoding), split as write_dataset does."""
    users, items = generate(spec)
    du, dv = spec.resolve()
    rng = np.random.default_rng(spec.seed + 1)
    tr, va = [], []
    for labels, feats in _flatten(users, du):
        labels = list(labels)
        rng.shuffle(labels)
        n_va = min(int(len(labels) * 0.2), max(0, len(labels) - 1))
        tr.append((sorted(labels[n_va:]), feats))
        if n_va:
            va.append((sorted(labels[:n_va]), feats))
    paths = [os.path.join(out, name) for name in ("items.fm", "train.fm",
                                                  "va.fm")]
    _write_rows(paths[0], _flatten(items, dv), with_labels=False)
    _write_rows(paths[1], tr, with_labels=True)
    _write_rows(paths[2], va, with_labels=True)
    return paths


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{tag: dict(item, train, va, users, model, ckpt)}: MF --ns, FFM with
    self blocks and FM with self blocks, each trained 2 epochs by the JAX
    Trainer at float64 and saved both ways."""
    out = {}
    for tag, kw in (("mf", dict(fu=1, fv=1)), ("ffm", {}), ("fm", {})):
        d = str(tmp_path_factory.mktemp(tag))
        spec = SynthSpec(n_users=60, n_items=25, avg_pos=10.0, seed=3, **kw)
        if tag == "fm":
            item, train, va = _fm_files(d, spec)
        else:
            item, train, va = write_dataset(d, spec)
        rec = dict(item=item, train=train, va=va,
                   users=_users_file(os.path.join(d, "users.txt"), va),
                   model=os.path.join(d, "model.txt"),
                   ckpt=os.path.join(d, "ck"))
        cfg = JaxConfig(item_path=item, train_path=train, test_path=va, k=3,
                        nr_pass=2, eval_every=2, dtype="float64",
                        model_path=rec["model"], ckpt_dir=rec["ckpt"],
                        eval_chunk=32, self_side=tag != "mf")
        trainer = JaxTrainer(cfg)
        trainer.init_state()
        trainer.run(log=lambda *_: None)
        out[tag] = rec
    return out


def _stable_positions(s, tol):
    """(rows whose K-th and (K+1)-th scores are more than tol apart,
    relative to the row's largest magnitude; positions < K whose score is
    more than tol from both neighbours'): where near-ties cannot decide the
    ranking.  ``s`` holds K+1 scores per row."""
    scale = np.maximum(np.abs(s).max(axis=1, keepdims=True), 1e-30)
    gap = np.diff(-s, axis=1) / scale > tol  # (rows, K): gap below t
    row_ok = gap[:, -1]
    left = np.concatenate([np.ones_like(gap[:, :1]), gap[:, :-1]], axis=1)
    return row_ok, left & gap


def _assert_same_ranking(ids_t, s_t, ids_j, s_j, k):
    ref = np.abs(s_j).max()
    assert np.abs(s_t.astype(np.float64) - s_j).max() <= TOL * ref
    row_ok, pos_ok = _stable_positions(s_j.astype(np.float64), TOL)
    assert row_ok.mean() > 0.5  # the check is not vacuous
    for i in np.nonzero(row_ok)[0]:
        assert set(ids_t[i, :k]) == set(ids_j[i, :k]), i
    np.testing.assert_array_equal(ids_t[:, :k][pos_ok], ids_j[:, :k][pos_ok])


CASES = {
    "scores": dict(with_scores=True),
    "catalog-popular": dict(catalog=15, popular="train"),
    "labeled": dict(labeled=True, with_scores=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("source", ["text", "ckpt"])
@pytest.mark.parametrize("tag", ["mf", "ffm", "fm"])
def test_predict_matches_jax(models, tag, source, case):
    rec = models[tag]
    kw = dict(CASES[case])
    if kw.get("popular"):
        kw["popular"] = jax_predict.read_data(rec["train"],
                                              has_label=True).popular
    users = rec["va"] if kw.get("labeled") else rec["users"]
    args = ((rec["model"], None) if source == "text"
            else (None, rec["ckpt"]))
    k = 5
    j_lay, j_k, j_params = jax_predict.load_any_model(*args)
    t_lay, t_k, t_params = torch_predict.load_any_model(*args)
    assert (t_lay.Du, t_lay.Dv, t_lay.self_side, t_k) == (
        j_lay.Du, j_lay.Dv, j_lay.self_side, j_k)
    # one more rank than asked, to see the gap below the K-th
    kw_all = dict(kw, with_scores=True)
    ids_j, s_j = jax_predict.predict_topk_from_model(
        j_lay, j_k, j_params, rec["item"], users, k + 1, **kw_all)
    ids_t, s_t = torch_predict.predict_topk_from_model(
        t_lay, t_k, t_params, rec["item"], users, k + 1, device="cpu",
        **kw_all)
    assert ids_t.shape == ids_j.shape
    _assert_same_ranking(ids_t, s_t, ids_j, s_j, k)
    # the call as asked: the same ids, scores only when asked for
    ids, scores = torch_predict.predict_topk_from_model(
        t_lay, t_k, t_params, rec["item"], users, k, device="cpu", **kw)
    np.testing.assert_array_equal(ids, ids_t[:, :k])
    assert (scores is None) != bool(kw.get("with_scores"))
    if not kw.get("labeled"):  # the two cold rows
        pop = np.zeros(kw.get("catalog", 25), np.float32)
        if kw.get("popular") is not None:
            n = min(len(pop), len(kw["popular"]))
            pop[:n] = kw["popular"][:n]
        want = np.argsort(-pop, kind="stable")[:k]
        np.testing.assert_array_equal(ids[-2:], [want, want])


@pytest.fixture(scope="module")
def tie_model(tmp_path_factory):
    """A model built of ties: FFM with self blocks whose tables hold small
    integers (exact in float32 and in the text model), items with equal
    feature rows, and cold user rows."""
    d = tmp_path_factory.mktemp("ties")
    rng = np.random.default_rng(0)
    layout = BlockLayout.make((4, 3), (5, 2), True)
    params = {b.f12: {"W": rng.integers(0, 2, size=(b.d1, 2)).astype(float),
                      "H": rng.integers(0, 2, size=(b.d2, 2)).astype(float)}
              for b in layout.all_blocks()}
    model = str(d / "model.txt")
    save_text_model(model, params, layout, 2)
    ckpt = str(d / "ck")
    save_checkpoint(ckpt, params, 0, TrainConfig(item_path="i",
                                                 train_path="t", k=2),
                    layout=dict(fu=2, fv=2, Du=[4, 3], Dv=[5, 2],
                                self_side=True))
    items = str(d / "items.txt")
    with open(items, "w") as fh:  # items 0-1, 2-3 and 5-6 share their rows
        for f0, f1 in ((0, 0), (0, 0), (1, 1), (1, 1), (2, 0), (3, 1),
                       (3, 1), (4, 0)):
            fh.write(f"0:{f0}:1 1:{f1}:1\n")
    users = str(d / "users.txt")
    with open(users, "w") as fh:
        for u0 in range(4):
            for u1 in range(3):
                fh.write(f"0:{u0}:1 1:{u1}:1\n")
        fh.write("0:9:1\n\n1:7:1\n")  # out of vocabulary or empty
    return dict(model=model, ckpt=ckpt, item=items, users=users)


@pytest.mark.parametrize("source", ["text", "ckpt"])
def test_ties_rank_lowest_id_first_as_jax(tie_model, source):
    args = ((tie_model["model"], None) if source == "text"
            else (None, tie_model["ckpt"]))
    out = []
    for mod, kw in ((jax_predict, {}), (torch_predict, dict(device="cpu"))):
        lay, k, params = mod.load_any_model(*args)
        out.append(mod.predict_topk_from_model(
            lay, k, params, tie_model["item"], tie_model["users"], 6,
            with_scores=True, **kw))
    (ids_j, s_j), (ids_t, s_t) = out
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(ids_t, ids_j)
    # ties are everywhere, and each is broken towards the lowest id
    assert (np.diff(s_t, axis=1) == 0).mean() > 0.3
    for row_ids, row_s in zip(ids_t, s_t):
        for t in range(5):
            if row_s[t] == row_s[t + 1]:
                assert row_ids[t] < row_ids[t + 1]
    # cold rows without a prior score 0 everywhere: ids 0..K-1
    np.testing.assert_array_equal(ids_t[-3:], np.tile(np.arange(6), (3, 1)))


def _main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["MODEL", "ITEMS", "USERS", "-k", "4"],
    ["MODEL", "ITEMS", "USERS", "-k", "3", "--scores"],
    ["--ckpt", "CKPT", "ITEMS", "USERS", "-k", "5", "--scores",
     "--catalog", "6"],
    ["--ckpt", "CKPT", "ITEMS", "USERS", "-k", "2", "--popular-from",
     "TRAIN"],
])
def test_main_prints_the_jax_lines(tie_model, tmp_path, argv):
    train = tmp_path / "train.txt"  # a popularity prior for the cold rows
    train.write_text("3,4 0:0:1\n4,6 0:1:1\n4 0:2:1\n")
    subst = dict(MODEL=tie_model["model"], CKPT=tie_model["ckpt"],
                 ITEMS=tie_model["item"], USERS=tie_model["users"],
                 TRAIN=str(train))
    argv = [subst.get(a, a) for a in argv]
    got = _main(torch_predict.main, argv + ["--platform", "cpu"])
    ref = _main(jax_predict.main, argv + ["--platform", "cpu"])
    assert got == ref
    assert got[0] == 0 and len(got[1].splitlines()) == 15
    if "--popular-from" in argv:
        assert got[2] == ""
        assert got[1].splitlines()[-1] == "4,3"
    else:  # the cold-user warning, word for word
        assert "3 user row(s) have no (in-vocabulary) features" in got[2]


@pytest.mark.parametrize("missing", ["model", "item file", "user file"])
def test_main_missing_file_as_jax(tie_model, tmp_path, missing):
    paths = [tie_model["model"], tie_model["item"], tie_model["users"]]
    paths[["model", "item file", "user file"].index(missing)] = str(
        tmp_path / "absent.txt")
    got = _main(torch_predict.main, paths + ["--platform", "cpu"])
    ref = _main(jax_predict.main, paths + ["--platform", "cpu"])
    assert got == ref
    assert got[0] == 1 and f"{missing} not found" in got[2]


def test_cuda_platform_without_a_card_is_an_error(tie_model, capsys):
    with pytest.raises(SystemExit) as exc:
        torch_predict.main([tie_model["model"], tie_model["item"],
                            tie_model["users"]])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    lay, k, params = torch_predict.load_any_model(tie_model["model"], None)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_predict.predict_topk_from_model(
            lay, k, params, tie_model["item"], tie_model["users"], 3)


def test_checkpoint_without_layout_raises_the_jax_message(tmp_path):
    params = {0: {"W": np.zeros((2, 2)), "H": np.zeros((3, 2))}}
    save_checkpoint(str(tmp_path), params, 1,
                    TrainConfig(item_path="i", train_path="t", k=2))
    msgs = []
    for mod in (jax_predict, torch_predict):
        with pytest.raises(ValueError) as exc:
            mod.load_any_model(None, str(tmp_path))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "no 'layout' entry" in msgs[0]


def test_port_checkpoint_gives_the_trainers_ids(models, tmp_path):
    """A checkpoint of the port's own Trainer (float32): predict ranks the
    test users as ``Trainer.predict_topk`` does, up to near-ties (the
    trainer's item caches are carried, predict's are recomputed)."""
    rec = models["ffm"]
    ckpt = str(tmp_path / "ck")
    trainer = Trainer(TrainConfig(item_path=rec["item"],
                                  train_path=rec["train"],
                                  test_path=rec["va"], k=4, nr_pass=2,
                                  eval_every=2, dtype="float32",
                                  ckpt_dir=ckpt, eval_chunk=16),
                      device="cpu")
    trainer.run(log=lambda *_: None)
    k = 5
    want = trainer.predict_topk(k=k)
    lay, kk, params = torch_predict.load_any_model(None, ckpt)
    ids, s = torch_predict.predict_topk_from_model(
        lay, kk, params, rec["item"], rec["va"], k + 1, labeled=True,
        popular=trainer.data.popular, with_scores=True, device="cpu")
    row_ok, pos_ok = _stable_positions(s.astype(np.float64), 1e-4)
    assert ids.shape[0] == want.shape[0] and row_ok.mean() > 0.5
    for i in np.nonzero(row_ok)[0]:
        assert set(ids[i, :k]) == set(want[i]), i
    np.testing.assert_array_equal(ids[:, :k][pos_ok], want[pos_ok])
