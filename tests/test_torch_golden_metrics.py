"""The JAX package's golden-metric holds (``tests/test_golden_metrics.py``,
the reference's nDCG debug tool protocol, gen_ans.py:27-42) on the port.

Monotone scores z_j = 10 - j rank a 10-item catalog as [0..9]; for known
label sets the port's numpy metrics and its Evaluator (the scores injected
through the cold-user popularity prior, which returns the popularity vector
verbatim) must give the hand formula's precision and nDCG, the Evaluator
the JAX Evaluator's metrics on the same inputs at rtol 1e-9; and two
training runs of the port must give the same tables bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_class_ffm_tpu.data.dataset import PaddedFields as JaxPaddedFields
from one_class_ffm_tpu.evalx import jax_eval
from one_class_ffm_tpu.models.blocks import BlockLayout as JaxBlockLayout
from one_class_ffm_torch.data.dataset import PaddedFields
from one_class_ffm_torch.evalx.numpy_metrics import ladder_metrics_np
from one_class_ffm_torch.evalx.torch_eval import Evaluator, make_eval_data
from one_class_ffm_torch.models.blocks import BlockLayout

torch.set_num_threads(1)


def dcg_at(ranks, k):
    """Independent hand formula: binary gain, 1/log2(rank+2), rank 0-based."""
    return sum(1.0 / math.log2(r + 2) for r in ranks if r < k)


def idcg_at(n_labels, k):
    return sum(1.0 / math.log2(r + 2) for r in range(min(n_labels, k)))


# catalog of 10, scores force ranking [0,1,2,...,9]
CASES = [
    # (labels, expected hit ranks)
    ([0, 1, 2], [0, 1, 2]),
    ([9], [9]),
    ([3, 7], [3, 7]),
    ([0, 5, 9, 12], [0, 5, 9]),  # label 12 outside catalog: counts in IDCG only
    ([2], [2]),
]


@pytest.mark.parametrize("labels,hit_ranks", CASES)
def test_numpy_metrics_against_hand_formula(labels, hit_ranks):
    z = np.arange(10, 0, -1, dtype=float)  # z_j = 10 - j -> ranking [0..9]
    hits, ndcgs, _ = ladder_metrics_np(z, np.array(labels), catalog=10)
    for s, K in enumerate((5, 10, 20, 40, 80)):
        kk = min(K, 10)
        exp_hits = sum(1 for r in hit_ranks if r < kk)
        exp_dcg = dcg_at(hit_ranks, kk)
        exp_idcg = idcg_at(len(labels), kk)
        assert hits[s] == exp_hits
        np.testing.assert_allclose(ndcgs[s], exp_dcg / exp_idcg, rtol=1e-12)


def _cold_users(cls):
    mt = len(CASES)
    return cls(
        m=mt, m_true=mt, f=1, Ds=(1,),
        idx=(np.zeros((mt, 1), np.int32),),
        val=(np.zeros((mt, 1)),),  # zero features -> every user is cold
        freq=(np.ones(1),),
        row_nnz=np.zeros(mt, np.int32),
    )


def test_evaluator_against_hand_formula():
    """Inject the monotone scores through the cold-user popularity path."""
    z = np.arange(10, 0, -1, dtype=float)
    va_labels = [np.array(l) for l, _ in CASES]
    meta, data = make_eval_data(
        _cold_users(PaddedFields), va_labels, popular=z, n_items=10,
        n_items_true=10, layout=BlockLayout.make([1], [1], self_side=False),
        dtype=torch.float64, device="cpu")
    ev = Evaluator(meta, data, chunk=4)
    layout = BlockLayout.make([1], [1], self_side=False)
    params = {b.f12: {"W": torch.zeros((1, 2), dtype=torch.float64),
                      "H": torch.zeros((1, 2), dtype=torch.float64)}
              for b in layout.all_blocks()}
    Q = {b.f12: torch.zeros((10, 2), dtype=torch.float64)
         for b in layout.cross_blocks()}
    got = ev.validate(params, Q, torch.zeros(10, dtype=torch.float64))
    for K in (5, 10):
        exp = np.mean([
            dcg_at(hr, min(K, 10)) / idcg_at(len(l), min(K, 10))
            for l, hr in CASES
        ])
        np.testing.assert_allclose(got[f"ndcg@{K}"], exp, rtol=1e-10)
        exp_p = np.mean([
            sum(1 for r in hr if r < min(K, 10)) / K for _, hr in CASES
        ])
        np.testing.assert_allclose(got[f"p@{K}"], exp_p, rtol=1e-10)
    # and the JAX Evaluator's whole metric dict on the same inputs
    jlay = JaxBlockLayout.make([1], [1], self_side=False)
    jmeta, jdata = jax_eval.make_eval_data(
        _cold_users(JaxPaddedFields), va_labels, popular=z, n_items=10,
        n_items_true=10, layout=jlay, dtype=jnp.float64)
    ref = jax_eval.Evaluator(jmeta, jdata, chunk=4).validate(
        {b.f12: {"W": jnp.zeros((1, 2)), "H": jnp.zeros((1, 2))}
         for b in jlay.all_blocks()},
        {b.f12: jnp.zeros((10, 2)) for b in jlay.cross_blocks()},
        jnp.zeros(10))
    assert set(got) == set(ref)
    for key, val in ref.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-9, err_msg=key)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_training_is_deterministic(tmp_path, dtype):
    """Same seed + data -> bitwise-identical parameters (the reference's
    structural race-freedom, SURVEY.md §5 sanitizers): the port's plain
    versions on the CPU, as its kernels on the card, add in a fixed order."""
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset
    from one_class_ffm_torch.train import TrainConfig, Trainer

    ds = write_dataset(str(tmp_path), SynthSpec(n_users=50, n_items=16,
                                                 seed=5))

    def run():
        cfg = TrainConfig(
            item_path=ds[0], train_path=ds[1], test_path=ds[2],
            k=3, nr_pass=2, eval_every=2, dtype=dtype, seed=11,
            eval_chunk=32,
        )
        t = Trainer(cfg, device="cpu")
        t.init_state()
        t.run(log=lambda *_: None)
        return t.params_numpy(), t.validate()

    (p1, m1), (p2, m2) = run(), run()
    assert m1 == m2
    for f12 in p1:
        np.testing.assert_array_equal(p1[f12]["W"], p2[f12]["W"])
        np.testing.assert_array_equal(p1[f12]["H"], p2[f12]["H"])
