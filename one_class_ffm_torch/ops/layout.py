"""The blocked layout of the positive stream, in numpy.

A line-for-line copy of ``make_blocked_layout`` from
``one_class_ffm_tpu/ops/sparse_ops.py``: that module imports ``jax`` at the
top, and the port must not.  ``tests/test_torch_layout.py`` holds the copy
equal to the original key by key.

The port's kernels rest on one property of the layout: within each block,
``own`` is non-decreasing and pad slots (``own == block_rows``) come last,
so each row's slots form one contiguous run.  The stable sort and the slot
fill below guarantee it; ``check_own_runs`` checks it.

``feature_major`` builds the other static input of the fused table
kernels: a field's X^T as a chunked feature-major list.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


def make_blocked_layout(seg_ids, take_ids, num_rows: int,
                        block_rows: int = 256, max_pad_ratio: float = 2.0,
                        shard_rows: int = 0, drop=None,
                        head_chunk: int = 512, nch_multiple: int = 8):
    """Host-side (numpy) block-aligned view of the COO stream, segmented by
    ``seg_ids``.  An unsorted segment side is stable-argsorted first — the
    per-call coefficient permutation this induces is a cheap (nnz,) scalar
    gather via ``src`` (unlike the measured-negative v-sorted PAYLOAD copy).

    Returns None when the layout does not apply: num_rows not divisible by
    block_rows, or row skew would pad the stream beyond max_pad_ratio (a
    power-user block sets MAXC for everyone).

    ``drop``: boolean mask of stream entries to EXCLUDE from the layout —
    the zero-weight pads.  They contribute exactly zero to every blocked op
    (coefficients carry the pad mask), but occupying slots inflates MAXC:
    in the shard-aligned layout all of a shard's pads pile into its last
    block.  ``src`` still indexes ORIGINAL stream positions.

    ``shard_rows`` > 0 (requires a SHARD-ALIGNED stream, pad_labels
    shard_rows=...): emit ``src`` SHARD-LOCALLY — relative to the owning
    shard's stream slice of length nnz/S — so the blocked ops can run under
    shard_map with each device gathering coefficients only from its own
    slice.  Requires the stream already sorted by ``seg_ids`` (the aligned
    layout is) and block/shard boundaries to nest (shard_rows % block_rows
    == 0).

    ``head_chunk`` > 0: when a popularity-skewed side would fail the
    pad-ratio guard (a handful of power rows set MAXC for everyone — the
    reference's load-imbalance case, schedule(guided) ffm.cpp:572), split
    TWO-TIER instead of rejecting: the heaviest rows' entries move to a
    chunked HEAD tier ((n_chunks, head_chunk) slots, each chunk owned by
    exactly ONE row, per-row padding < one chunk) and the TAIL tier is the
    ordinary blocked layout over ALL rows with the head entries dropped —
    so its MAXC collapses to the tail's max and every dense per-row term
    still runs once over the full row space.  Extra keys: hd_src/hd_take
    (n_chunks, head_chunk), hd_row/hd_loc (n_chunks,) global row id /
    compact head index per chunk, hd_valid, hd_rows (the (n_head,) sorted
    global head row list), chunk.  ``inv`` then maps into the CONCATENATED
    flat slot space (tail slots first, head slots at offset
    n_blocks * MAXC).  Composes with ``shard_rows`` (round 5): head src
    stays GLOBAL (assembly/carry-propagation only — runtime consumes
    slot-order carried coefficients), the tail keeps shard-local src, and
    ``nch_multiple`` pads the chunk count so the chunk dim can shard
    evenly.  hd_src always indexes ORIGINAL stream positions."""
    import numpy as np

    if block_rows <= 0 or num_rows % block_rows or num_rows == 0:
        return None
    nnz = int(seg_ids.shape[0])
    if nnz == 0:
        return None
    if shard_rows and (shard_rows % block_rows or num_rows % shard_rows
                       or nnz % (num_rows // shard_rows)):
        return None
    seg = np.asarray(seg_ids)
    back = None  # sorted-kept position -> ORIGINAL stream position
    if drop is not None and np.any(drop):
        back = np.nonzero(~np.asarray(drop))[0].astype(np.int64)
        seg = seg[back]
    nnz_k = int(seg.shape[0])
    if nnz_k == 0:
        return None
    needed_sort = bool(np.any(np.diff(seg) < 0))
    if needed_sort:
        order = np.argsort(seg, kind="stable").astype(np.int64)
        seg = seg[order]
        back = order if back is None else back[order]
    n_blocks = num_rows // block_rows

    def block_counts(s):
        starts = np.searchsorted(s, np.arange(0, num_rows + 1, block_rows))
        return starts, np.diff(starts)

    starts, counts = block_counts(seg)
    MAXC = max(8, -(-int(counts.max()) // 8) * 8)  # sublane-friendly
    # cost guard: blocked passes stream n_blocks*MAXC slots; the plain ops
    # they replace stream the whole padded stream (nnz, pads included)
    head_sel = None  # (hd_rows, hd_cnt, hd_first) of the head tier
    if n_blocks * MAXC > max_pad_ratio * nnz:
        if head_chunk <= 0:
            return None
        # two-tier split: over a T ladder, pick the per-row count threshold
        # whose tail layout + chunked head tier stream the FEWEST total
        # slots (n_blocks*MAXC_tail + head slots).  Minimizing head size
        # alone is wrong: it leaves tail MAXC near the power rows' counts,
        # which keeps the kt/fused kernels' per-block VMEM estimates
        # rejected — the whole point of the split is a SMALL tail MAXC.
        rowcnt = np.bincount(seg, minlength=num_rows)
        maxcnt = int(rowcnt.max())
        # the head is for POWER rows only: cap it at 1/8 of the nonzero
        # rows (unbounded min-cost degenerates to moving EVERYTHING head-
        # side on small problems), and weight head slots 1.5x in the cost
        # (per-chunk overheads + the scatter over head rows)
        nh_cap = min(1 << 16, max(16, int((rowcnt > 0).sum()) // 8))
        best = None  # (cost, T, maxc_t, head mask)
        T = maxcnt
        while T >= head_chunk:
            T //= 2
            head = rowcnt > T
            n_head = int(head.sum())
            if n_head == 0:
                continue
            if n_head > nh_cap:
                break  # smaller T only grows the head further
            _, bc = block_counts(seg[~head[seg]])
            if bc.size == 0 or bc.max() == 0:
                break  # tail emptied — not a power-row split
            maxc_t = max(8, -(-int(bc.max()) // 8) * 8)
            hd_slots = int(
                (-(-rowcnt[head] // head_chunk) * head_chunk).sum())
            # feasibility: the ACTUAL streamed slots vs the plain ops'
            # stream; selection: head slots weighted 1.5x (chunk overheads
            # + the per-head-row scatter)
            if n_blocks * maxc_t + hd_slots > max_pad_ratio * nnz:
                continue
            cost = n_blocks * maxc_t + 1.5 * hd_slots
            if best is None or cost < best[0]:
                best = (cost, T, maxc_t, head)
        if best is None:
            return None
        _, _, MAXC, head = best
        hd_rows = np.nonzero(head)[0].astype(np.int64)
        head_sel = (hd_rows, rowcnt[hd_rows],
                    np.searchsorted(seg, hd_rows))

    def slots(s, bk, strt, cnts, maxw):
        offs = np.arange(maxw, dtype=np.int64)[None, :]
        pos = strt[:, None] + offs  # positions in seg order
        valid = offs < cnts[:, None]
        pos = np.where(valid, np.minimum(pos, s.shape[0] - 1), 0)
        sr = pos if bk is None else bk[pos]  # ORIGINAL stream positions
        sr = np.where(valid, sr, 0).astype(np.int32)
        tk = np.where(valid, np.asarray(take_ids)[sr], 0).astype(np.int32)
        return sr, tk, pos, valid

    if head_sel is not None:
        hd_rows, hd_cnt, hd_first = head_sel
        hm = np.zeros(num_rows, bool)
        hm[hd_rows] = True
        keep_t = ~hm[seg]
        seg_t = seg[keep_t]
        back_t = (np.nonzero(keep_t)[0] if back is None
                  else back[keep_t]).astype(np.int64)
        starts_t, counts_t = block_counts(seg_t)
    else:
        seg_t, back_t, starts_t, counts_t = seg, back, starts, counts
    src, take, pos, valid = slots(seg_t, back_t, starts_t[:-1], counts_t,
                                  MAXC)
    own_local = np.where(
        valid,
        seg_t[pos]
        - (np.arange(n_blocks, dtype=np.int64) * block_rows)[:, None],
        block_rows,  # pad marker: one-hot row of all zeros
    ).astype(np.int32)
    # inverse map: ORIGINAL stream position -> flat slot index (kept entries
    # only; dropped entries point at slot 0 — their consumers multiply by the
    # zero pad weight, so the value never matters).  Lets per-entry results
    # computed in slot order (e.g. the residual gap) permute back to stream
    # order with one (nnz,) scalar gather.
    offs = np.arange(MAXC, dtype=np.int64)[None, :]
    flat = (np.arange(n_blocks, dtype=np.int64)[:, None] * MAXC
            + offs).astype(np.int32)
    inv = np.zeros(nnz, np.int32)
    inv[src[valid]] = flat[valid]
    out = dict(src=src, own=own_local, take=take, inv=inv,
               block_rows=block_rows, maxc=MAXC)
    if head_sel is not None:
        # head tier: one chunk row owns head_chunk consecutive entries of
        # exactly one head row (entries of a row are contiguous — seg is
        # sorted); per-row padding < one chunk.  Chunk count pads to a
        # multiple of 8 with all-pad chunks (hd_valid False -> zero weight).
        nch_r = (-(-hd_cnt // head_chunk)).astype(np.int64)
        m_nch = max(8, int(nch_multiple))
        NCH = -(-int(nch_r.sum()) // m_nch) * m_nch
        hd_row = np.full(NCH, hd_rows[0], np.int64)
        hd_loc = np.zeros(NCH, np.int64)
        cum = np.cumsum(nch_r) - nch_r
        fill = np.repeat(np.arange(len(hd_rows)), nch_r)
        hd_row[: len(fill)] = hd_rows[fill]
        hd_loc[: len(fill)] = fill
        chunk_in_row = np.arange(len(fill)) - cum[fill]
        cstart = np.zeros(NCH, np.int64)
        cstart[: len(fill)] = hd_first[fill] + chunk_in_row * head_chunk
        cend = np.zeros(NCH, np.int64)
        cend[: len(fill)] = hd_first[fill] + hd_cnt[fill]
        offs_h = np.arange(head_chunk, dtype=np.int64)[None, :]
        pos_h = cstart[:, None] + offs_h
        valid_h = pos_h < cend[:, None]
        pos_h = np.where(valid_h, np.minimum(pos_h, nnz_k - 1), 0)
        src_h = pos_h if back is None else back[pos_h]
        src_h = np.where(valid_h, src_h, 0).astype(np.int32)
        take_h = np.where(valid_h,
                          np.asarray(take_ids)[src_h], 0).astype(np.int32)
        flat_h = (n_blocks * MAXC
                  + np.arange(NCH, dtype=np.int64)[:, None] * head_chunk
                  + offs_h).astype(np.int32)
        inv[src_h[valid_h]] = flat_h[valid_h]
        out.update(hd_src=src_h, hd_take=take_h,
                   hd_row=hd_row.astype(np.int32),
                   hd_loc=hd_loc.astype(np.int32), hd_valid=valid_h,
                   hd_rows=hd_rows.astype(np.int64), chunk=head_chunk)
    if shard_rows:
        if needed_sort:
            return None  # shard-local src needs the seg-sorted stream
        L = nnz // (num_rows // shard_rows)
        lo = (np.arange(n_blocks, dtype=np.int64)
              // (shard_rows // block_rows) * L)[:, None].astype(np.int32)
        if not (np.all(src[valid] >= np.broadcast_to(lo, src.shape)[valid])
                and np.all(src[valid]
                           < np.broadcast_to(lo + L, src.shape)[valid])):
            raise ValueError(
                "stream is not shard-aligned: a block's entries cross its "
                "shard's stream slice (build labels with pad_labels "
                "shard_rows=...)")
        out["src_abs"] = src
        out["src"] = np.where(valid, src - lo, 0).astype(np.int32)
    return out


XT_CHUNK = 128  # entries per chunk of the feature-major list


class FeatureMajor(NamedTuple):
    """One field's X^T as a feature-major list of its nonzero entries, in
    fixed chunks: the static input of the fused table kernels' X^T pass.

    ``row``/``val`` (nnz,): the data row and value of each entry, sorted by
    feature, then row, then slot.  ``chunk_ptr`` (n_chunks + 1,): chunk c
    holds entries ``[chunk_ptr[c], chunk_ptr[c + 1])``, all of one feature
    and at most ``XT_CHUNK`` of them.  ``feat_ptr`` (d + 1,): feature f owns
    chunks ``[feat_ptr[f], feat_ptr[f + 1])``.  ``n_rows``: the row count of
    the payload the list scatters from."""

    row: Any
    val: Any
    chunk_ptr: Any
    feat_ptr: Any
    n_rows: int


def feature_major(idx: np.ndarray, val: np.ndarray, d: int,
                  chunk: int = XT_CHUNK) -> FeatureMajor:
    """The feature-major list of a padded field ``(rows, p)``.  Pad slots
    and pad rows (val == 0) are dropped: they add nothing, and left in they
    would pile every row's pads onto feature 0.  Duplicate ids within a row
    stay separate entries and add, as the one-hot X of the TPU kernels
    adds them.  A feature's run is cut into chunks of ``chunk`` entries so
    that a heavy feature (a class base carrying a tenth of all rows) is
    summed by many warps, then combined chunk by chunk in a fixed order."""
    idx = np.asarray(idx)
    val = np.asarray(val)
    rows, p = idx.shape
    keep = (val != 0).reshape(-1)
    feat = idx.reshape(-1)[keep].astype(np.int64)
    if feat.size and (feat.min() < 0 or feat.max() >= d):
        raise ValueError(f"feature ids outside [0, {d})")
    row = np.repeat(np.arange(rows, dtype=np.int64), p)[keep]
    v = val.reshape(-1)[keep]
    order = np.argsort(feat, kind="stable")  # keeps (row, slot) order
    feat, row, v = feat[order], row[order], v[order]
    cnt = np.bincount(feat, minlength=d)
    n_ch = -(-cnt // chunk)
    feat_ptr = np.zeros(d + 1, np.int64)
    feat_ptr[1:] = np.cumsum(n_ch)
    feat_start = np.cumsum(cnt) - cnt
    owner = np.repeat(np.arange(d), n_ch)
    j = np.arange(owner.size) - feat_ptr[owner]
    chunk_ptr = np.append(feat_start[owner] + j * chunk, feat.size)
    return FeatureMajor(row=row.astype(np.int32), val=v,
                        chunk_ptr=chunk_ptr.astype(np.int32),
                        feat_ptr=feat_ptr.astype(np.int32), n_rows=rows)


def check_own_runs(own: np.ndarray, block_rows: int) -> None:
    """Raise unless every block's ``own`` row is non-decreasing with the pad
    marker (``block_rows``) only at the end — the contiguous-run property the
    blocked kernels rely on."""
    own = np.asarray(own)
    if own.ndim != 2:
        raise ValueError(f"own must be (n_blocks, MAXC), got {own.shape}")
    if own.size and (own.min() < 0 or own.max() > block_rows):
        raise ValueError("own holds slot owners outside [0, block_rows]")
    if own.shape[1] > 1 and np.any(np.diff(own, axis=1) < 0):
        raise ValueError(
            "blocked layout breaks the contiguous-run property: a block's "
            "own row decreases (rows' slots are not contiguous runs)")
