"""Host-side dataset containers (numpy) and device-ready padded views.

A copy of ``one_class_ffm_tpu/data/dataset.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Mirrors the capabilities of the reference ``ImpData`` (reference ffm.h:59-79,
ffm.cpp:80-294): read → split_fields → transY, plus per-field dims ``Ds``,
per-feature frequencies ``freq`` and the item popularity prior ``popular``.

TPU-side representation: variable-nnz CSR rows are converted to fixed-width
*padded* per-field arrays ``idx[m, p_f]``/``val[m, p_f]`` (pad entries have
``val == 0`` so they vanish in both the projection P = X·W and the scatter
gradient Xᵀz), and the positive labels to a flat COO stream
``(pos_u, pos_v)``.  Both have static shapes, which is what XLA needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .io import read_text_file

Arr = np.ndarray


@dataclass
class Interactions:
    """Positive (row, col) pairs in flat COO, row-major sorted."""

    m: int  # number of rows (users for U-major, items for V-major)
    n: int  # number of cols
    indptr: Arr  # (m+1,) int64 — row pointer
    col: Arr  # (nnz,) int64 — column ids

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def row_ids(self) -> Arr:
        """Expand indptr to one row id per nonzero."""
        counts = np.diff(self.indptr)
        return np.repeat(np.arange(self.m, dtype=np.int64), counts)

    def counts(self) -> Arr:
        return np.diff(self.indptr).astype(np.int64)


@dataclass
class FieldData:
    """One side's feature matrix, split per field (reference ffm.cpp:185-257)."""

    m: int  # rows
    f: int  # number of fields
    Ds: List[int]  # per-field dimension (max idx + 1 seen)
    indptr: List[Arr]  # per field: (m+1,) row pointers
    idx: List[Arr]  # per field: (nnz_f,) feature ids
    val: List[Arr]  # per field: (nnz_f,) values
    freq: List[Arr]  # per field: (Ds[f],) feature occurrence counts

    def row_nnz(self) -> Arr:
        """Total features per row across fields (reference ``nnx``)."""
        total = np.zeros(self.m, dtype=np.int64)
        for fi in range(self.f):
            total += np.diff(self.indptr[fi])
        return total


@dataclass
class RawData:
    """Parsed but not yet field-split data for one side."""

    file_name: str
    m: int
    n: int  # label dimension (0 if no labels)
    f: int
    x_indptr: Arr
    x_fid: Arr
    x_idx: Arr
    x_val: Arr
    y: Optional[Interactions]  # labels (None when has_label=False)
    popular: Optional[Arr]  # normalized item label counts


def read_data(
    path: str,
    has_label: bool,
    ds: Optional[Sequence[int]] = None,
    force_python: bool = False,
) -> RawData:
    """Read a text data file (reference ImpData::read, ffm.cpp:80-183)."""
    x_indptr, x_fid, x_idx, x_val, y_indptr, y_idx, n, f = read_text_file(
        path, has_label, ds, force_python=force_python
    )
    m = int(x_indptr.shape[0] - 1)
    y = None
    popular = None
    if has_label:
        y = Interactions(m=m, n=n, indptr=y_indptr, col=y_idx)
        popular = np.zeros(n, dtype=np.float64)
        np.add.at(popular, y_idx, 1.0)
        total = popular.sum()
        if total > 0:
            popular /= total
    return RawData(
        file_name=path,
        m=m,
        n=n,
        f=f,
        x_indptr=x_indptr,
        x_fid=x_fid,
        x_idx=x_idx,
        x_val=x_val,
        y=y,
        popular=popular,
    )


def split_fields(raw: RawData, f_override: Optional[int] = None) -> FieldData:
    """Re-bucket features by field (reference ImpData::split_fields,
    ffm.cpp:185-257): per-field CSR, per-field dims Ds, frequency counts."""
    f = int(f_override if f_override is not None else raw.f)
    m = raw.m
    indptr: List[Arr] = []
    idxs: List[Arr] = []
    vals: List[Arr] = []
    Ds: List[int] = []
    freqs: List[Arr] = []

    # Row id for every nonzero of the unsplit CSR.
    counts = np.diff(raw.x_indptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)

    for fi in range(f):
        sel = raw.x_fid == fi
        r = rows[sel]
        i = raw.x_idx[sel]
        v = raw.x_val[sel]
        # Stable sort by row keeps the original intra-row feature order.
        order = np.argsort(r, kind="stable")
        r, i, v = r[order], i[order], v[order]
        ptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(ptr, r + 1, 1)
        ptr = np.cumsum(ptr)
        d = int(i.max()) + 1 if i.size else 0
        fr = np.zeros(d, dtype=np.int64)
        if i.size:
            np.add.at(fr, i, 1)
        indptr.append(ptr)
        idxs.append(i)
        vals.append(v)
        Ds.append(d)
        freqs.append(fr)

    return FieldData(m=m, f=f, Ds=Ds, indptr=indptr, idx=idxs, val=vals, freq=freqs)


def trans_y(user_y: Interactions, n_items: int) -> Interactions:
    """Build the item→user adjacency from the user→item one (reference
    ImpData::transY, ffm.cpp:259-294).  Labels with item id >= ``n_items``
    (items absent from the item feature file) are dropped (ffm.cpp:267-268).
    """
    u = user_y.row_ids()
    v = user_y.col
    keep = v < n_items
    u, v = u[keep], v[keep]
    order = np.lexsort((u, v))  # sort by item then user (ffm.cpp:274-279)
    u, v = u[order], v[order]
    indptr = np.zeros(n_items + 1, dtype=np.int64)
    np.add.at(indptr, v + 1, 1)
    indptr = np.cumsum(indptr)
    return Interactions(m=n_items, n=user_y.m, indptr=indptr, col=u)


# ---------------------------------------------------------------------------
# Device-ready padded views
# ---------------------------------------------------------------------------


@dataclass
class PaddedFields:
    """Fixed-width per-field feature arrays (static shapes for XLA).

    Pad entries have ``val == 0`` and ``idx == 0``: they contribute nothing to
    P = X·W (0 * W[0]) nor to the scatter gradient Xᵀz (scatter of 0).
    """

    m: int  # padded row count
    m_true: int  # real row count
    f: int
    Ds: Tuple[int, ...]
    idx: Tuple[Arr, ...]  # per field (m, p_f) int32
    val: Tuple[Arr, ...]  # per field (m, p_f) float
    freq: Tuple[Arr, ...]  # per field (Ds[f],) float (for freq-weighted lambda)
    row_nnz: Arr  # (m,) int32 — real feature count per row (all fields)


def _round_up(x: int, mult: int) -> int:
    x = max(x, 1)  # never produce zero-row device arrays
    return ((x + mult - 1) // mult) * mult if mult > 1 else x


def pad_fields(
    fd: FieldData,
    row_multiple: int = 1,
    dtype=np.float32,
    min_width: int = 1,
) -> PaddedFields:
    """Convert field-split CSR to padded arrays; optionally pad the row count
    to a multiple (for even sharding across a device mesh)."""
    m_pad = _round_up(fd.m, row_multiple)
    idxs, vals = [], []
    for fi in range(fd.f):
        cnt = np.diff(fd.indptr[fi])
        p = max(int(cnt.max()) if cnt.size else 0, min_width)
        I = np.zeros((m_pad, p), dtype=np.int32)
        V = np.zeros((m_pad, p), dtype=dtype)
        nnz = fd.idx[fi].shape[0]
        if nnz:
            rows = np.repeat(np.arange(fd.m, dtype=np.int64), cnt)
            # position within row
            pos = np.arange(nnz, dtype=np.int64) - np.repeat(fd.indptr[fi][:-1], cnt)
            I[rows, pos] = fd.idx[fi].astype(np.int32)
            V[rows, pos] = fd.val[fi].astype(dtype)
        idxs.append(I)
        vals.append(V)
    row_nnz = np.zeros(m_pad, dtype=np.int32)
    row_nnz[: fd.m] = fd.row_nnz().astype(np.int32)
    return PaddedFields(
        m=m_pad,
        m_true=fd.m,
        f=fd.f,
        Ds=tuple(fd.Ds),
        idx=tuple(idxs),
        val=tuple(vals),
        freq=tuple(fr.astype(dtype) for fr in fd.freq),
        row_nnz=row_nnz,
    )


@dataclass
class PaddedLabels:
    """Flat COO positive pairs padded to a static length.

    Pad entries point at row ``m_true`` / col ``n_true`` — one extra "ghost"
    segment absorbed by segment_sum with num_segments = true + 1 and then
    sliced away, so pads never touch real rows.
    """

    nnz: int  # padded length
    nnz_true: int
    u: Arr  # (nnz,) int32 user/row ids (ghost = m_true)
    v: Arr  # (nnz,) int32 item/col ids (ghost = n_true)
    w: Arr  # (nnz,) float — 1.0 for real pairs, 0.0 for pads
    count_u: Arr  # (m_pad,) per-user positive count |Ω⁺_i|
    count_v: Arr  # (n_pad,) per-item positive count


def pad_labels(
    y: Interactions,
    m_pad: int,
    n_pad: int,
    nnz_multiple: int = 1,
    dtype=np.float32,
    shard_rows: int = 0,
) -> PaddedLabels:
    """``shard_rows`` > 0: SHARD-ALIGNED stream layout for an S-way data
    mesh (S = m_pad / shard_rows).  The u-sorted stream is split at user-row
    boundaries and each shard's slice is padded to a common length, so an
    even (nnz/S) sharding of the stream puts every row's positives on the
    SAME device as the row itself — which is what lets the blocked-sorted
    positive ops run shard-locally under shard_map (no collectives inside
    the pass).  Pad entries keep the invariants every consumer relies on:
    w == 0 (contributions vanish), u non-decreasing (pads carry the shard's
    last row id), v a valid id (the true-item ghost column)."""
    u = y.row_ids().astype(np.int32)
    v = y.col.astype(np.int32)
    nnz_true = u.shape[0]
    if shard_rows and shard_rows < m_pad:
        if m_pad % shard_rows:
            raise ValueError(
                f"shard_rows={shard_rows} must divide padded rows {m_pad}")
        S = m_pad // shard_rows
        bounds = np.arange(0, m_pad + 1, shard_rows)
        starts = np.searchsorted(u, bounds)
        lens = np.diff(starts)
        L = _round_up(int(lens.max()), 8)  # per-shard stream length
        nnz = S * L
        up = np.repeat(bounds[1:].astype(np.int32) - 1, L)  # shard-local pad
        vp = np.full(nnz, y.n, dtype=np.int32)
        wp = np.zeros(nnz, dtype=dtype)
        offs = np.arange(L, dtype=np.int64)[None, :]
        pos = starts[:-1, None] + offs
        valid = offs < lens[:, None]
        srcpos = np.where(valid, np.minimum(pos, max(nnz_true - 1, 0)), 0)
        dst = (np.arange(S, dtype=np.int64) * L)[:, None] + offs
        if nnz_true:
            up[dst[valid]] = u[srcpos[valid]]
            vp[dst[valid]] = v[srcpos[valid]]
            wp[dst[valid]] = 1.0
    else:
        nnz = _round_up(max(nnz_true, 1), nnz_multiple)
        up = np.full(nnz, y.m, dtype=np.int32)
        vp = np.full(nnz, y.n, dtype=np.int32)
        wp = np.zeros(nnz, dtype=dtype)
        up[:nnz_true] = u
        vp[:nnz_true] = v
        wp[:nnz_true] = 1.0
    cu = np.zeros(m_pad, dtype=dtype)
    cv = np.zeros(n_pad, dtype=dtype)
    np.add.at(cu, u, 1.0)
    np.add.at(cv, v, 1.0)
    return PaddedLabels(
        nnz=nnz, nnz_true=nnz_true, u=up, v=vp, w=wp, count_u=cu, count_v=cv
    )
