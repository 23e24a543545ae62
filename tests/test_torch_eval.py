"""The port's Evaluator against the JAX Evaluator and the numpy metrics
oracle, with forced score ties (model and popularity) and cold users."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_to_padded, make_problem
from one_class_ffm_tpu.data.dataset import PaddedFields
from one_class_ffm_tpu.evalx import jax_eval
from one_class_ffm_tpu.evalx.numpy_metrics import validate_np
from one_class_ffm_torch.evalx import torch_eval

torch.set_num_threads(1)


def build(cold_rows=(), self_side=True, catalog=None, row_pad=0, seed=0):
    rng = np.random.default_rng(seed)
    prob, params = make_problem(rng, m=17, n=11, self_side=self_side)
    m, n, lay = prob.m, prob.n, prob.layout
    catalog = n if catalog is None else catalog
    Xu = [X.copy() for X in prob.Xu]
    for i in cold_rows:
        for X in Xu:
            X[i, :] = 0.0
    P = {b.f12: Xu[b.fi] @ params["W"][b.f12] for b in lay.cross_blocks()}
    Q = {b.f12: prob.Xv[b.fj] @ params["H"][b.f12]
         for b in lay.cross_blocks()}
    bt = rng.normal(size=n) * 0.1
    # forced ties: items 1, 3 and 6 score identically for every warm user
    for q in Q.values():
        q[3] = q[1]
        q[6] = q[1]
    bt[3] = bt[6] = bt[1]
    at = np.zeros(m)
    for b in lay.user_self_blocks():
        at += np.einsum("ik,ik->i", Xu[b.fi] @ params["W"][b.f12],
                        Xu[b.fj] @ params["H"][b.f12])
    popular = rng.random(catalog)
    popular[4] = popular[2] = popular[0]  # ties in the cold-user prior
    popular /= popular.sum()
    scores = [popular.copy() if i in cold_rows
              else bt + sum(Q[f] @ P[f][i] for f in P) for i in range(m)]
    va_labels = [np.nonzero(prob.pos[i])[0] for i in range(m)]
    ref = validate_np(scores, va_labels, at, catalog, n)

    m_pad = m + row_pad
    pads = [dense_to_padded(X, m_pad) for X in Xu]
    row_nnz = sum((X != 0).sum(axis=1) for X in Xu).astype(np.int32)
    uva = PaddedFields(
        m=m_pad, m_true=m, f=len(Xu), Ds=tuple(X.shape[1] for X in Xu),
        idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
        freq=tuple(np.ones(X.shape[1]) for X in Xu),
        row_nnz=np.concatenate([row_nnz, np.zeros(row_pad, np.int32)]))

    jmeta, jdata = jax_eval.make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=jnp.float64)
    jgot = jax_eval.Evaluator(jmeta, jdata, chunk=5).validate(
        {b.f12: {"W": jnp.asarray(params["W"][b.f12]),
                 "H": jnp.asarray(params["H"][b.f12])}
         for b in lay.all_blocks()},
        {f: jnp.asarray(q) for f, q in Q.items()}, jnp.asarray(bt))

    tmeta, tdata = torch_eval.make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=torch.float64, device="cpu")
    tgot = torch_eval.Evaluator(tmeta, tdata, chunk=5).validate(
        {b.f12: {"W": torch.from_numpy(params["W"][b.f12]),
                 "H": torch.from_numpy(params["H"][b.f12])}
         for b in lay.all_blocks()},
        {f: torch.from_numpy(q) for f, q in Q.items()}, torch.from_numpy(bt))
    return ref, jgot, tgot


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cold_rows=(0, 4)),
    dict(self_side=False),
    dict(catalog=6),
    dict(row_pad=3),
    dict(cold_rows=(2,), row_pad=2, catalog=7),
])
def test_validate_matches_jax_and_numpy(kw):
    ref, jgot, tgot = build(**kw)
    assert set(tgot) == set(jgot)
    for key, val in ref.items():
        np.testing.assert_allclose(tgot[key], val, rtol=1e-8, atol=1e-10,
                                   err_msg=key)
    for key, val in jgot.items():
        np.testing.assert_allclose(tgot[key], val, rtol=1e-10, atol=1e-12,
                                   err_msg=key)


def test_ties_rank_the_lowest_index_first():
    """A chunk where every score ties: the top-K is 0, 1, 2, ... and the
    hit pattern follows it exactly (torch.topk would promise no order)."""
    rng = np.random.default_rng(0)
    prob, params = make_problem(rng, m=3, n=30, self_side=False)
    lay = prob.layout
    uva = PaddedFields(
        m=3, m_true=3, f=len(prob.Xu), Ds=tuple(X.shape[1] for X in prob.Xu),
        idx=tuple(dense_to_padded(X)[0] for X in prob.Xu),
        val=tuple(dense_to_padded(X)[1] for X in prob.Xu),
        freq=tuple(np.ones(X.shape[1]) for X in prob.Xu),
        row_nnz=np.ones(3, np.int32))
    labels = [np.array([0, 7]), np.array([29]), np.array([4])]
    meta, data = torch_eval.make_eval_data(
        uva, labels, np.full(30, 1 / 30), n_items=30, n_items_true=30,
        layout=lay, dtype=torch.float64, device="cpu")
    ev = torch_eval.Evaluator(meta, data, chunk=3)
    params_t = {b.f12: {"W": torch.zeros(b.d1, 3), "H": torch.zeros(b.d2, 3)}
                for b in lay.all_blocks()}
    Q = {b.f12: torch.zeros(30, 3, dtype=torch.float64)
         for b in lay.cross_blocks()}
    got = ev.validate(params_t, Q, torch.zeros(30, dtype=torch.float64))
    # hits at ranks 0 (item 0) and 4 (item 4) only -> p@5 = 2 / (3 * 5)
    assert got["p@5"] == pytest.approx(2 / 15)
    assert got["p@10"] == pytest.approx(3 / 30)  # item 7 at rank 7
    assert got["auc"] == pytest.approx(0.5)
