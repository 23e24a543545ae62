"""The generator: the same seed gives the same inputs, and every seed the
configuration's counts."""

import numpy as np
import pytest

from ocffm_bench import gen
from ocffm_bench.tests.common import load

CFGS = ["kkbox-ffm-k64", "kkbox-mf-k32"]


def small(name):
    cfg = load(f"configs/{name}.json")
    cfg.update(users=3000, items=20000)
    return cfg


@pytest.mark.parametrize("name", CFGS)
def test_same_seed_same_inputs(name):
    cfg, tr = small(name), load("traffic/train-skew.json")
    a = gen.make_problem(cfg, tr, 2 ** 31 + 11)
    b = gen.make_problem(cfg, tr, 2 ** 31 + 11)
    c = gen.make_problem(cfg, tr, 2 ** 31 + 12)
    assert np.array_equal(a.pos_u, b.pos_u) and np.array_equal(a.pos_v,
                                                               b.pos_v)
    for x, y in zip(a.users.idx + a.items.idx, b.users.idx + b.items.idx):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.pos_v, c.pos_v)
    assert a.pos_u.shape == c.pos_u.shape


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("mix", ["train-skew", "train-uniform"])
def test_counts_follow_the_configuration(name, mix):
    cfg, tr = small(name), load(f"traffic/{mix}.json")
    p = gen.make_problem(cfg, tr, 7)
    s = gen.summary(p)
    assert s["users"] == cfg["users"] and s["items"] == cfg["items"]
    assert s["user_dims"] == gen.field_dims(cfg, "user")
    assert s["item_dims"] == gen.field_dims(cfg, "item")
    assert s["user_nnz"] == [1 if f["kind"] == "id" else len(f["groups"])
                             for f in cfg["user_fields"]]
    law = cfg["positives_per_user"]
    want = round(cfg["users"] * law["mean"] * cfg["train_share"])
    assert s["positives"] == want
    keys = p.pos_u * cfg["items"] + p.pos_v
    assert np.all(np.diff(keys) > 0)  # sorted by (u, v), no repeats
    assert np.allclose(p.popular.sum(), 1.0)
    assert np.array_equal(np.bincount(p.pos_u, minlength=cfg["users"]).sum(),
                          want)


def test_full_size_profile():
    cfg = load("configs/kkbox-ffm-k64.json")
    prof = gen.count_profile(cfg)
    assert prof.sum() == round(30755 * 120.8 * 0.8) == 2972163
    assert prof.min() >= 1 and prof.max() < 359966 // 2
    assert gen.field_dims(cfg, "item") == [359966, 40000]
    assert gen.field_dims(cfg, "user") == [30755, 32]


def test_categorical_ids_stay_in_their_groups():
    cfg = small("kkbox-ffm-k64")
    p = gen.make_problem(cfg, load("traffic/train-skew.json"), 3)
    idx = p.items.idx[1]
    lo = np.cumsum([0] + cfg["item_fields"][1]["groups"])
    for g in range(3):
        assert np.all((idx[:, g] >= lo[g]) & (idx[:, g] < lo[g + 1]))


def test_skew_puts_a_head_on_the_items():
    cfg = small("kkbox-ffm-k64")
    skew = gen.summary(gen.make_problem(cfg, load("traffic/train-skew.json"),
                                        1))
    flat = gen.summary(gen.make_problem(
        cfg, load("traffic/train-uniform.json"), 1))
    assert skew["top_item_share"] > 5 * flat["top_item_share"]


@pytest.mark.parametrize("mix", ["train-skew", "train-uniform"])
def test_every_seed_the_same_work(mix):
    """Two seeds relabel one problem: the positives of each user and of
    each item, in row order, and the features' multisets are the same."""
    cfg, tr = small("kkbox-ffm-k64"), load(f"traffic/{mix}.json")
    a = gen.make_problem(cfg, tr, 2 ** 31 + 21)
    b = gen.make_problem(cfg, tr, 2 ** 31 + 22)
    for n, pa, pb in ((cfg["users"], a.pos_u, b.pos_u),
                      (cfg["items"], a.pos_v, b.pos_v)):
        assert np.array_equal(np.bincount(pa, minlength=n),
                              np.bincount(pb, minlength=n))
    assert not np.array_equal(a.pos_v, b.pos_v)
    for x, y in zip(a.items.idx, b.items.idx):
        assert np.array_equal(np.sort(x, axis=0), np.sort(y, axis=0))
    assert np.array_equal(a.popular, b.popular)
