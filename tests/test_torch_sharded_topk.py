"""The item-sharded global top-K merge on 4 gloo ranks against one device
(mirrors ``tests/test_sharded_topk.py``).

Each rank holds a quarter of the catalog, takes its local top-K with the
port's tie-exact ``rank_topk`` and the ranks' candidates merge in rank
order: the ids must be ``jax.lax.top_k``'s on the whole score matrix bit
for bit, ties to the lowest global id, also on a matrix of ties, with k
above the items per rank, with cold users and with a catalog mask.  One
spawned group runs every case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.predict import rank_topk

torch.set_num_threads(1)

RANKS = 4


def scores_case(rng, chunk=6, n=64, kd=4, blocks=2):
    Pva = {i: rng.normal(size=(chunk, kd)) for i in range(blocks)}
    Q = {i: rng.normal(size=(n, kd)) for i in range(blocks)}
    return Pva, Q, rng.normal(size=(n,))


def full_scores(Pva, Q, bt):
    z = torch.from_numpy(bt)[None, :]
    for f in sorted(Q):
        z = z + torch.from_numpy(Pva[f]) @ torch.from_numpy(Q[f]).T
    return z.numpy()


def build_cases():
    rng = np.random.default_rng(0)
    cases = {}
    Pva, Q, bt = scores_case(rng)
    cases["random"] = dict(kind="one_shot", Pva=Pva, Q=Q, bt=bt, k=10)
    cases["all_ties"] = dict(kind="one_shot", Pva={0: np.zeros((4, 3))},
                             Q={0: np.zeros((64, 3))}, bt=np.zeros(64),
                             k=12)
    Pva, Q, bt = scores_case(rng, n=32)
    cases["k_above_shard"] = dict(kind="one_shot", Pva=Pva, Q=Q, bt=bt,
                                  k=12)  # 8 items per rank
    # a tie-heavy matrix: scores in {0, 1, 2}, many equal in every row
    z = rng.integers(0, 3, size=(9, 64)).astype(np.float64)
    cases["tie_heavy"] = dict(kind="raw", z=z, bt=np.zeros(64), Pva={},
                              Q={}, k=20)
    Pva, Q, bt = scores_case(rng, chunk=8, n=64)
    cold = np.zeros(8, bool)
    cold[[1, 5]] = True
    popular = np.round(rng.random(64) * 4) / 4  # ties in the prior too
    cases["serving"] = dict(kind="serving", Pva=Pva, Q=Q, bt=bt, k=7,
                            cold=cold, popular=popular, catalog=50)
    return cases


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    cases = build_cases()
    out = spawn("torch_mesh_worker:mesh_topk", RANKS, args=(cases,),
                workdir=str(tmp_path_factory.mktemp("topk4")))
    return cases, out


def expected(c):
    """(vals, ids) of ``jax.lax.top_k`` on the whole catalog."""
    if c["kind"] == "raw":
        z = c["z"]
    else:
        z = full_scores(c["Pva"], c["Q"], c["bt"])
    if c["kind"] == "serving":
        z = np.where(c["cold"][:, None], c["popular"][None, :], z)
        z = z[:, : c["catalog"]]
    vals, ids = jax.lax.top_k(jnp.asarray(z), c["k"])
    return np.asarray(vals), np.asarray(ids)


@pytest.mark.parametrize("name", ["random", "k_above_shard", "serving"])
def test_matches_single_device(merged, name):
    cases, out = merged
    ref_vals, ref_ids = expected(cases[name])
    for vals, ids in (o[name] for o in out):
        np.testing.assert_allclose(vals, ref_vals, rtol=1e-12)
        np.testing.assert_array_equal(ids, ref_ids)


def test_tie_breaking_lowest_global_index(merged):
    """Equal scores everywhere: the top-K is [0, 1, 2, ...], as the
    reference's first-max destructive argmax gives."""
    _, out = merged
    for vals, ids in (o["all_ties"] for o in out):
        np.testing.assert_array_equal(ids, np.tile(np.arange(12), (4, 1)))
        assert np.all(vals == 0.0)


def test_tie_heavy_matrix_matches_lax_top_k(merged):
    """Scores in {0, 1, 2}: every row's ties cross the ranks' slices; the
    merged ids are ``jax.lax.top_k``'s and ``rank_topk``'s bit for bit."""
    cases, out = merged
    c = cases["tie_heavy"]
    ref_vals, ref_ids = expected(c)
    own = rank_topk(torch.from_numpy(c["z"]), c["k"])[1].numpy()
    np.testing.assert_array_equal(own, ref_ids)
    for vals, ids in (o["tie_heavy"] for o in out):
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(vals, ref_vals)


def test_every_rank_returns_the_merge(merged):
    _, out = merged
    for name in out[0]:
        for o in out[1:]:
            np.testing.assert_array_equal(o[name][1], out[0][name][1])
