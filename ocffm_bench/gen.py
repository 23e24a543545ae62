"""The benchmark's data generator: one configuration and one traffic mix,
made from a seed, in vectorised numpy.

Every seed gets the same problem in another order, so that every seed
gives the program the same amount of work: the side features, the
positives (a fixed profile of counts per user, the items drawn by a fixed
popularity) all come from ``STRUCTURE_SEED``.  The run's seed relabels
the users and the items, each only among those with the same number of
positives, so that the counts in row order, and with them every padded
layout, stay as they are.  The initial tables are drawn once from
``STRUCTURE_SEED`` too and relabeled with the rows
(``reference.ffm_ref.start_tables``): every seed trains one problem, with
its rows in another order.  The seed also draws the requests.  Nothing here calls
the program: its output is the plain input that the program and the
reference are both handed.

A side's fields are listed in the configuration: an ``id`` field is the
identity (row i has feature i with value 1), a ``categorical`` field has
one feature from each of its ``groups`` per row (value 1), the groups'
ids laid side by side, so its width is the sum of the groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.special import ndtri


# the seed of the orders that every run shares: which user holds which
# count of positives, which item holds which popularity rank
STRUCTURE_SEED = 20260101


@dataclass
class Side:
    """One side's features, padded per field: ``idx[f]``, ``val[f]`` of
    shape (rows, nnz per row); ``dims[f]`` the field's width."""

    rows: int
    dims: List[int]
    idx: List[np.ndarray]  # int32
    val: List[np.ndarray]  # float32
    ident: List[bool]


@dataclass
class Problem:
    users: Side
    items: Side
    pos_u: Optional[np.ndarray]  # (nnz,) int64, sorted by (u, v)
    pos_v: Optional[np.ndarray]
    popular: np.ndarray  # (items,) float64, sums to 1
    user_label: np.ndarray  # the row that each drawn user was moved to
    item_label: np.ndarray


def side_rows(cfg: dict, side: str) -> int:
    return int(cfg["users"] if side == "user" else cfg["items"])


def field_dims(cfg: dict, side: str) -> List[int]:
    rows = side_rows(cfg, side)
    return [rows if f["kind"] == "id" else int(sum(f["groups"]))
            for f in cfg[side + "_fields"]]


def make_side(cfg: dict, side: str, rng: np.random.Generator) -> Side:
    rows = side_rows(cfg, side)
    dims, idx, val, ident = [], [], [], []
    for f in cfg[side + "_fields"]:
        if f["kind"] == "id":
            dims.append(rows)
            idx.append(np.arange(rows, dtype=np.int32)[:, None])
            ident.append(True)
        elif f["kind"] == "categorical":
            groups = [int(g) for g in f["groups"]]
            offs = np.concatenate([[0], np.cumsum(groups)[:-1]])
            cols = [o + rng.integers(0, g, size=rows)
                    for o, g in zip(offs, groups)]
            dims.append(int(sum(groups)))
            idx.append(np.stack(cols, axis=1).astype(np.int32))
            ident.append(False)
        else:
            raise ValueError(f"unknown field kind {f['kind']!r}")
        val.append(np.ones(idx[-1].shape, np.float32))
    return Side(rows, dims, idx, val, ident)


def count_profile(cfg: dict) -> np.ndarray:
    """Positives per user, sorted: the quantiles of the configured law,
    scaled so that they sum to ``round(users * mean * train_share)``, each
    at most half the catalog.  The same for every seed."""
    m, n = int(cfg["users"]), int(cfg["items"])
    law = cfg["positives_per_user"]
    total = int(round(m * float(law["mean"]) * float(cfg["train_share"])))
    if law["law"] == "lognormal":
        q = (np.arange(m) + 0.5) / m
        w = np.exp(float(law["sigma"]) * ndtri(q))
    elif law["law"] == "constant":
        w = np.ones(m)
    else:
        raise ValueError(f"unknown count law {law['law']!r}")
    c = w / w.sum() * total
    base = np.maximum(np.floor(c).astype(np.int64), 1)
    cap = max(1, n // 2)
    base = np.minimum(base, cap)
    short = total - int(base.sum())
    frac_order = np.argsort(-(c - np.floor(c)), kind="stable")
    i = 0
    while short != 0:
        j = frac_order[i % m]
        if short > 0 and base[j] < cap:
            base[j] += 1
            short -= 1
        elif short < 0 and base[j] > 1:
            base[j] -= 1
            short += 1
        i += 1
    return base


def popularity(n: int, law: dict, rng: np.random.Generator) -> np.ndarray:
    """Item weights (sum 1): Zipf over ranks that ``rng`` deals to the
    items, or uniform."""
    if law["law"] == "uniform":
        return np.full(n, 1.0 / n)
    if law["law"] != "zipf":
        raise ValueError(f"unknown popularity law {law['law']!r}")
    ranks = rng.permutation(n)
    w = (1.0 + ranks) ** -float(law["exponent"])
    return w / w.sum()


def draw_positives(counts: np.ndarray, weights: np.ndarray,
                   rng: np.random.Generator):
    """For user i, ``counts[i]`` distinct items drawn by ``weights``
    (rejection of repeats, in rounds); returns (u, v) sorted by (u, v)."""
    m, n = len(counts), len(weights)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    have = np.zeros(m, np.int64)
    keys = np.empty(0, np.int64)
    for _ in range(64):
        need = counts - have
        if not need.any():
            break
        ask = np.where(need > 0, need + need // 4 + 2, 0)
        u = np.repeat(np.arange(m, dtype=np.int64), ask)
        v = np.searchsorted(cdf, rng.random(u.shape[0]), side="right")
        v = np.minimum(v, n - 1)
        cand = u * n + v
        # a random order, then each key's first appearance
        perm = rng.permutation(cand.shape[0])
        cand = cand[perm]
        _, first = np.unique(cand, return_index=True)
        cand = cand[np.sort(first)]
        cand = cand[~np.isin(cand, keys, assume_unique=True)]
        cu = cand // n
        order = np.argsort(cu, kind="stable")
        cand, cu = cand[order], cu[order]
        start = np.searchsorted(cu, np.arange(m))
        rank = np.arange(cand.shape[0]) - start[cu]
        take = cand[rank < need[cu]]
        have += np.bincount(take // n, minlength=m)
        keys = np.union1d(keys, take)
    if (have != counts).any():
        raise RuntimeError("positive draws did not fill every user")
    return keys // n, keys % n


def class_relabel(counts: np.ndarray, rng: np.random.Generator
                  ) -> np.ndarray:
    """A random new label for each row, drawn only among the rows with
    the same count: ``new[i]`` has ``counts[new[i]] == counts[i]``."""
    order = np.argsort(counts, kind="stable")
    shuffled = np.lexsort((rng.random(counts.shape[0]), counts))
    new = np.empty_like(order)
    new[order] = shuffled
    return new


def relabel_side(side: Side, new: np.ndarray) -> Side:
    """The side with row i moved to row ``new[i]`` (an id field stays the
    identity: its feature is the row)."""
    inv = np.argsort(new)
    idx = [a if s else a[inv] for a, s in zip(side.idx, side.ident)]
    val = [a if s else a[inv] for a, s in zip(side.val, side.ident)]
    return Side(side.rows, side.dims, idx, val, side.ident)


def make_problem(cfg: dict, traffic: dict, seed: int,
                 with_positives: bool = True) -> Problem:
    """The inputs of one run: both sides' features, the training positives
    (left out where the traffic trains nothing) and the items' popularity
    prior (each item's share of the positives, or of the law where no
    positives are drawn)."""
    rng = np.random.default_rng(int(seed))
    fixed = np.random.default_rng(STRUCTURE_SEED)
    users = make_side(cfg, "user", fixed)
    items = make_side(cfg, "item", fixed)
    weights = popularity(items.rows, traffic["item_popularity"], fixed)
    m, n = users.rows, items.rows
    if not with_positives:
        new_u, new_v = rng.permutation(m), rng.permutation(n)
        pop = np.empty_like(weights)
        pop[new_v] = weights
        return Problem(relabel_side(users, new_u), relabel_side(items, new_v),
                       None, None, pop, new_u, new_v)
    counts = count_profile(cfg)[fixed.permutation(m)]
    pos_u, pos_v = draw_positives(counts, weights, fixed)
    new_u = class_relabel(counts, rng)
    new_v = class_relabel(np.bincount(pos_v, minlength=n), rng)
    keys = np.sort(new_u[pos_u] * n + new_v[pos_v])
    pos_u, pos_v = keys // n, keys % n
    pop = np.bincount(pos_v, minlength=n).astype(np.float64)
    pop /= pop.sum()
    return Problem(relabel_side(users, new_u), relabel_side(items, new_v),
                   pos_u, pos_v, pop, new_u, new_v)


def summary(p: Problem) -> Dict[str, object]:
    """Counts that a test or a log line can hold against the configuration."""
    out: Dict[str, object] = dict(
        users=p.users.rows, items=p.items.rows,
        user_dims=list(p.users.dims), item_dims=list(p.items.dims),
        user_nnz=[int(a.shape[1]) for a in p.users.idx],
        item_nnz=[int(a.shape[1]) for a in p.items.idx])
    if p.pos_u is not None:
        cnt = np.bincount(p.pos_u, minlength=p.users.rows)
        top = np.bincount(p.pos_v, minlength=p.items.rows)
        out.update(positives=int(p.pos_u.shape[0]),
                   max_user_positives=int(cnt.max()),
                   top_item_share=float(top.max() / p.pos_u.shape[0]))
    return out


def rows_of(side: Side, ids: Sequence[int]):
    """The padded field arrays of some rows (a request's users)."""
    ids = np.asarray(ids)
    return [a[ids] for a in side.idx], [a[ids] for a in side.val]
