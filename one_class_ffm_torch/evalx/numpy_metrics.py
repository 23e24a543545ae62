"""Numpy reference implementation of the ranking metrics.

A copy of ``one_class_ffm_tpu/evalx/numpy_metrics.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Reproduces the reference evaluation semantics exactly (used as the oracle for
the TPU metrics and as a CPU fallback):

  * top-K ladder K = 5, 10, 20, 40, 80 (init_va, ffm.cpp:896-909)
  * Precision@K: cumulative hits over the ladder, averaged as
    hits / (num_users * K); ranking by repeated first-max-wins argmax
    (prec_k, ffm.cpp:1018-1057) — equivalent to a stable descending sort.
    Train positives are NOT masked from the ranking.
  * nDCG@K: binary gain 1/log2(rank+2); IDCG truncates at
    min(#test labels, K) where #labels counts every label, including ids
    outside the catalog (ndcg, ffm.cpp:1059-1128).
  * ranking is over the first ``catalog`` item ids (= the training label
    dimension, U->popular.size(), ffm.cpp:1031,1073).
  * AUC (new metric, absent from the reference): probability a positive
    outranks a negative, ties count 1/2; negatives = catalog minus the test
    positives of that user.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

TOP_K_LADDER: Tuple[int, ...] = (5, 10, 20, 40, 80)

Arr = np.ndarray


def ladder_metrics_np(
    z: Arr,
    labels: Arr,
    catalog: int,
    top_ks: Sequence[int] = TOP_K_LADDER,
) -> Tuple[Arr, Arr, float]:
    """Per-user metrics for one score vector.

    Args:
      z: (>= catalog,) scores; only the first ``catalog`` entries are ranked.
      labels: test positive ids for this user (may contain ids >= catalog —
        they can never be hit but still count toward IDCG).
      catalog: number of rankable items.

    Returns:
      (hits_per_state, ndcg_per_state, auc) where hits/ndcg follow the
      cumulative-ladder semantics above.
    """
    nk = len(top_ks)
    kmax = min(max(top_ks), catalog)
    zc = np.asarray(z[:catalog], dtype=np.float64)
    # First-max-wins repeated argmax == stable sort by (-z, index).
    order = np.argsort(-zc, kind="stable")[:kmax]
    label_set = set(int(x) for x in labels)
    hit = np.array([1.0 if int(j) in label_set else 0.0 for j in order])
    gains = 1.0 / np.log2(np.arange(kmax) + 2.0)

    nl = len(labels)
    hits = np.zeros(nk)
    ndcgs = np.zeros(nk)
    for s, K in enumerate(top_ks):
        kk = min(K, catalog)
        hits[s] = hit[:kk].sum()
        dcg = float((hit[:kk] * gains[:kk]).sum())
        ikk = min(nl, kk)
        idcg = float(gains[:ikk].sum())
        ndcgs[s] = dcg / idcg if idcg > 0 else 0.0

    # AUC over the catalog; in-catalog positives only.
    pos_ids = np.array([j for j in label_set if j < catalog], dtype=np.int64)
    npos = pos_ids.size
    nneg = catalog - npos
    if npos == 0 or nneg == 0:
        auc = 0.5
    else:
        zpos = zc[pos_ids]
        less = (zc[None, :] < zpos[:, None]).sum(axis=1).astype(np.float64)
        ties = (zc[None, :] == zpos[:, None]).sum(axis=1).astype(np.float64)
        # remove self-comparisons from the tie counts, and other positives
        # from both counts
        ties -= 1.0
        less_pos = (zpos[None, :] < zpos[:, None]).sum(axis=1).astype(np.float64)
        ties_pos = (zpos[None, :] == zpos[:, None]).sum(axis=1).astype(np.float64) - 1.0
        auc = float(
            ((less - less_pos) + 0.5 * (ties - ties_pos)).sum() / (npos * nneg)
        )
    return hits, ndcgs, auc


def validate_np(
    score_rows,
    va_labels,
    at,
    catalog: int,
    n_items: int,
    top_ks: Sequence[int] = TOP_K_LADDER,
):
    """Aggregate metrics over users (reference validate, ffm.cpp:925-1016).

    Args:
      score_rows: iterable of per-user score vectors (already including the
        item side term bt and the popularity fallback for cold users).
      va_labels: list of per-user test label id arrays.
      at: per-user self side term (enters ploss only, not the ranking).
      catalog: rankable item count (train label dim).
      n_items: z vector length for warm users (ploss guard j < n_items).

    Returns dict with p@K, ndcg@K (both fractions, not x100), ploss, auc.
    """
    nk = len(top_ks)
    mt = len(va_labels)
    hits = np.zeros(nk)
    ndcgs = np.zeros(nk)
    aucs = 0.0
    ploss = 0.0
    for i, (z, labs) in enumerate(zip(score_rows, va_labels)):
        for j in labs:
            if j < min(len(z), n_items):
                d = 1.0 - z[j] - at[i]
                ploss += d * d
        h, nd, auc = ladder_metrics_np(z, labs, catalog, top_ks)
        hits += h
        ndcgs += nd
        aucs += auc
    out = {}
    for s, K in enumerate(top_ks):
        out[f"p@{K}"] = hits[s] / (mt * K)
        out[f"ndcg@{K}"] = ndcgs[s] / mt
    out["ploss"] = float(np.sqrt(ploss / mt))
    out["auc"] = aucs / mt
    return out
