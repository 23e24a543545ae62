"""Synthetic one-class FFM dataset generator.

A copy of ``one_class_ffm_tpu/data/synth.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Produces data in the reference text format (label list + ``fid:idx:val``)
and, faster, directly as in-memory arrays — used by the end-to-end tests,
the benchmark (BASELINE.json synthetic web-scale config), and as a stand-in
for the KDD12/Outbrain/KKBox pipelines when raw Kaggle data is unavailable.

The generative model plants a low-rank preference structure so ranking
metrics move visibly during training: users/items get latent class ids and
positives are sampled with in-class affinity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SynthSpec:
    n_users: int = 1000
    n_items: int = 200
    fu: int = 2  # user fields
    fv: int = 2  # item fields
    dims_u: Optional[Tuple[int, ...]] = None  # default: (n_users, 50)
    dims_v: Optional[Tuple[int, ...]] = None  # default: (n_items, 30)
    avg_pos: float = 5.0  # positives per user
    n_classes: int = 8
    affinity: float = 0.8  # prob a positive stays in the user's class
    max_extra_nnz: int = 2  # extra features per non-id field
    seed: int = 0
    # > 0: zipf-like item popularity (weight ~ rank^-pop_skew) for positive
    # draws — real catalogs are head-heavy; exercises the blocked-layout
    # skew guard and gives honest throughput numbers for skewed streams
    pop_skew: float = 0.0

    def resolve(self):
        du = self.dims_u or tuple(
            [self.n_users] + [50] * (self.fu - 1)
        )
        dv = self.dims_v or tuple([self.n_items] + [30] * (self.fv - 1))
        return du[: self.fu], dv[: self.fv]


def generate(spec: SynthSpec):
    """Returns (user_lines, item_lines): per-row (labels, feats) structures.

    feats: list of (fid, idx, val).  Field 0 on each side is an id field
    (mf-style); remaining fields carry class-correlated categorical features.
    """
    rng = np.random.default_rng(spec.seed)
    du, dv = spec.resolve()
    u_class = rng.integers(0, spec.n_classes, size=spec.n_users)
    v_class = rng.integers(0, spec.n_classes, size=spec.n_items)
    items_by_class: List[np.ndarray] = [
        np.nonzero(v_class == c)[0] for c in range(spec.n_classes)
    ]
    pop_w = None
    pop_by_class: List[np.ndarray] = []
    if spec.pop_skew > 0:
        # item j's popularity rank is a fixed permutation of the catalog
        ranks = rng.permutation(spec.n_items)
        pop_w = (1.0 + ranks) ** -float(spec.pop_skew)
        pop_w = pop_w / pop_w.sum()
        for c in range(spec.n_classes):
            wc = pop_w[items_by_class[c]]
            pop_by_class.append(wc / wc.sum() if wc.size else wc)

    def draw_item(own, c):
        if own.size and rng.random() < spec.affinity:
            if pop_w is None:
                return int(own[rng.integers(own.size)])
            return int(rng.choice(own, p=pop_by_class[c]))
        if pop_w is None:
            return int(rng.integers(spec.n_items))
        return int(rng.choice(spec.n_items, p=pop_w))

    user_rows = []
    for i in range(spec.n_users):
        n_pos = max(1, rng.poisson(spec.avg_pos))
        labels = set()
        own = items_by_class[u_class[i]]
        for _ in range(n_pos):
            labels.add(draw_item(own, int(u_class[i])))
        feats = [(0, i % du[0], 1.0)]
        for fi in range(1, spec.fu):
            base = (u_class[i] * (du[fi] // spec.n_classes)) % max(du[fi], 1)
            feats.append((fi, int(base), 1.0))
            for _ in range(rng.integers(0, spec.max_extra_nnz + 1)):
                feats.append((fi, int(rng.integers(du[fi])), 1.0))
        user_rows.append((sorted(labels), feats))

    item_rows = []
    for j in range(spec.n_items):
        feats = [(0, j % dv[0], 1.0)]
        for fi in range(1, spec.fv):
            base = (v_class[j] * (dv[fi] // spec.n_classes)) % max(dv[fi], 1)
            feats.append((fi, int(base), 1.0))
            for _ in range(rng.integers(0, spec.max_extra_nnz + 1)):
                feats.append((fi, int(rng.integers(dv[fi])), 1.0))
        item_rows.append(([], feats))
    return user_rows, item_rows


def _write_rows(path: str, rows, with_labels: bool):
    with open(path, "w") as out:
        for labels, feats in rows:
            parts = []
            if with_labels:
                parts.append(",".join(str(x) for x in labels))
            for fid, idx, val in feats:
                v = int(val) if float(val).is_integer() else val
                parts.append(f"{fid}:{idx}:{v}")
            out.write(" ".join(parts) + "\n")


def write_dataset(
    out_dir: str, spec: SynthSpec, va_frac: float = 0.2
) -> Tuple[str, str, str]:
    """Write item/train/va files in the reference text format; the validation
    split moves a fraction of each user's labels (users keep their features).
    Returns (item_path, train_path, va_path)."""
    rng = np.random.default_rng(spec.seed + 1)
    user_rows, item_rows = generate(spec)
    tr_rows, va_rows = [], []
    for labels, feats in user_rows:
        labels = list(labels)
        rng.shuffle(labels)
        n_va = int(len(labels) * va_frac)
        if len(labels) - n_va < 1:
            n_va = max(0, len(labels) - 1)
        va, tr = labels[:n_va], labels[n_va:]
        tr_rows.append((sorted(tr), feats))
        # a row's label block must be non-empty in the text format, so users
        # whose split leaves no validation labels are not emitted to the va
        # file (matches the reference prep pipelines, which only emit rows
        # for observed positives)
        if va:
            va_rows.append((sorted(va), feats))
    os.makedirs(out_dir, exist_ok=True)
    item_path = os.path.join(out_dir, "items.ffm")
    train_path = os.path.join(out_dir, "train.ffm")
    va_path = os.path.join(out_dir, "va.ffm")
    _write_rows(item_path, item_rows, with_labels=False)
    _write_rows(train_path, tr_rows, with_labels=True)
    _write_rows(va_path, va_rows, with_labels=True)
    return item_path, train_path, va_path


def build_padded(spec: SynthSpec, dtype=np.float32, row_multiple: int = 8,
                 shard_rows: int = 0):
    """Generate directly to device-ready padded arrays (no text round-trip).

    Returns (layout_args, u_pad, v_pad, y_pad) where layout_args =
    (Du, Dv) per-field dims actually observed.  Used by the benchmark and
    the multichip dry-run.  ``shard_rows``: build the labels SHARD-ALIGNED
    (pad_labels) for the shard_map blocked path.
    """
    from .dataset import PaddedFields, PaddedLabels, pad_labels, Interactions

    user_rows, item_rows = generate(spec)
    du, dv = spec.resolve()

    def side(rows, dims, mult):
        m = len(rows)
        m_pad = -(-m // mult) * mult
        f = len(dims)
        idxs, vals = [], []
        width = [1] * f
        for _, feats in rows:
            cnt = [0] * f
            for fid, _, _ in feats:
                cnt[fid] += 1
            for fi in range(f):
                width[fi] = max(width[fi], cnt[fi])
        for fi in range(f):
            idxs.append(np.zeros((m_pad, width[fi]), dtype=np.int32))
            vals.append(np.zeros((m_pad, width[fi]), dtype=dtype))
        freq = [np.zeros(d, dtype=dtype) for d in dims]
        row_nnz = np.zeros(m_pad, dtype=np.int32)
        for i, (_, feats) in enumerate(rows):
            slot = [0] * f
            for fid, idx, val in feats:
                idxs[fid][i, slot[fid]] = idx
                vals[fid][i, slot[fid]] = val
                slot[fid] += 1
                freq[fid][idx] += 1
            row_nnz[i] = len(feats)
        return PaddedFields(
            m=m_pad, m_true=m, f=f, Ds=tuple(dims),
            idx=tuple(idxs), val=tuple(vals), freq=tuple(freq),
            row_nnz=row_nnz,
        )

    u_pad = side(user_rows, list(du), row_multiple)
    v_pad = side(item_rows, list(dv), row_multiple)
    rows_ids = []
    cols = []
    for i, (labels, _) in enumerate(user_rows):
        rows_ids.extend([i] * len(labels))
        cols.extend(labels)
    rows_ids = np.asarray(rows_ids, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    indptr = np.zeros(len(user_rows) + 1, dtype=np.int64)
    np.add.at(indptr, rows_ids + 1, 1)
    y = Interactions(
        m=len(user_rows), n=spec.n_items, indptr=np.cumsum(indptr), col=cols
    )
    y_pad = pad_labels(y, u_pad.m, v_pad.m, nnz_multiple=row_multiple * 8,
                       dtype=dtype, shard_rows=shard_rows)
    return (list(du), list(dv)), u_pad, v_pad, y_pad


def generate_vectorized(spec: SynthSpec, dtype=np.float32, row_multiple: int = 8):
    """Vectorized generator straight to padded device arrays.

    Same generative model as ``generate``/``build_padded`` (planted classes,
    id field + class-correlated side features) but pure numpy array ops — no
    Python per-row loops.  ~100x faster; required for the web-scale configs
    (the loop version takes ~280 s at 2M users).  The random stream differs
    from ``generate`` (different draw order), so datasets are statistically
    equivalent, not identical.

    Returns the same structure as ``build_padded``.
    """
    from .dataset import Interactions, PaddedFields, pad_labels

    rng = np.random.default_rng(spec.seed)
    du, dv = spec.resolve()
    nu, nv = spec.n_users, spec.n_items
    u_class = rng.integers(0, spec.n_classes, size=nu)
    v_class = rng.integers(0, spec.n_classes, size=nv)

    # positives: per-user draw counts, in-class with prob affinity
    n_pos = np.maximum(1, rng.poisson(spec.avg_pos, size=nu))
    total = int(n_pos.sum())
    pos_u = np.repeat(np.arange(nu, dtype=np.int64), n_pos)
    in_class = rng.random(total) < spec.affinity
    # per-class item pools (sorted by class); empty classes fall back uniform
    order = np.argsort(v_class, kind="stable")
    class_start = np.searchsorted(v_class[order], np.arange(spec.n_classes))
    class_end = np.searchsorted(v_class[order], np.arange(spec.n_classes), "right")
    cls = u_class[pos_u]
    size = (class_end - class_start)[cls]
    offset = (rng.random(total) * np.maximum(size, 1)).astype(np.int64)
    in_class &= size > 0
    picked_in = order[np.minimum(class_start[cls] + offset, len(order) - 1)]
    picked_uni = rng.integers(0, nv, size=total)
    pos_v = np.where(in_class, picked_in, picked_uni)
    # dedup (u, v): unique sorted keys decode straight to u-major order
    key = np.unique(pos_u * np.int64(nv) + pos_v)
    pos_u, pos_v = key // nv, key % nv
    ptr = np.zeros(nu + 1, dtype=np.int64)
    cnt = np.bincount(pos_u, minlength=nu)
    ptr[1:] = np.cumsum(cnt)
    y = Interactions(m=nu, n=nv, indptr=ptr, col=pos_v)

    def side(n_rows, dims, classes, mult):
        m_pad = -(-max(n_rows, 1) // mult) * mult
        f = len(dims)
        idxs, vals, freqs = [], [], []
        # field 0: identity id feature
        i0 = np.zeros((m_pad, 1), dtype=np.int32)
        v0 = np.zeros((m_pad, 1), dtype=dtype)
        i0[:n_rows, 0] = np.arange(n_rows) % dims[0]
        v0[:n_rows, 0] = 1.0
        idxs.append(i0)
        vals.append(v0)
        fr0 = np.bincount(i0[:n_rows, 0], minlength=dims[0]).astype(dtype)
        freqs.append(fr0)
        row_nnz = np.zeros(m_pad, dtype=np.int32)
        row_nnz[:n_rows] = 1
        for fi in range(1, f):
            width = 1 + spec.max_extra_nnz
            I = np.zeros((m_pad, width), dtype=np.int32)
            V = np.zeros((m_pad, width), dtype=dtype)
            base = (classes * (dims[fi] // spec.n_classes)) % max(dims[fi], 1)
            I[:n_rows, 0] = base
            V[:n_rows, 0] = 1.0
            n_extra = rng.integers(0, spec.max_extra_nnz + 1, size=n_rows)
            extra_ids = rng.integers(0, dims[fi], size=(n_rows, spec.max_extra_nnz))
            slot = np.arange(spec.max_extra_nnz)[None, :]
            mask = slot < n_extra[:, None]
            I[:n_rows, 1:] = np.where(mask, extra_ids, 0)
            V[:n_rows, 1:] = np.where(mask, 1.0, 0.0).astype(dtype)
            idxs.append(I)
            vals.append(V)
            fr = np.bincount(
                I[:n_rows].ravel(), weights=V[:n_rows].ravel(),
                minlength=dims[fi],
            ).astype(dtype)
            freqs.append(fr)
            row_nnz[:n_rows] += 1 + n_extra.astype(np.int32)
        return PaddedFields(m=m_pad, m_true=n_rows, f=f, Ds=tuple(dims),
                            idx=tuple(idxs), val=tuple(vals),
                            freq=tuple(freqs), row_nnz=row_nnz)

    u_pad = side(nu, list(du), u_class, row_multiple)
    v_pad = side(nv, list(dv), v_class, row_multiple)
    y_pad = pad_labels(y, u_pad.m, v_pad.m, nnz_multiple=row_multiple * 8,
                       dtype=dtype)
    return (list(du), list(dv)), u_pad, v_pad, y_pad
