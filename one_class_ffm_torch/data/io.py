"""Text parsers for the one-class FFM data formats.

A copy of ``one_class_ffm_tpu/data/io.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Format (shared by .ffm / .fm / .mf encodings — they differ only in how many
fields the encoders emit): one example per line,

    [label1,label2,...] fid:idx:val fid:idx:val ...

where the optional leading label block is a comma-separated list of positive
item ids and each feature is a ``field:index:value`` triple.  Semantics mirror
the reference parser (reference ffm.cpp:80-183):

  * ``n`` (label dimension) = max label id + 1 across the file.
  * ``f`` = max field id + 1, counted over *all* features, including features
    later dropped by the ``ds`` filter (ffm.cpp:103-104).
  * when ``ds`` (per-field training dims) is given, features with
    ``idx >= ds[fid]`` are dropped — used for test files so unseen feature ids
    vanish (ffm.cpp:104,149).  Field ids beyond ``len(ds)`` are dropped too
    (out-of-bounds in the reference; defined behavior here).
  * ``popular`` = per-item label counts normalized to sum 1 (ffm.cpp:122-123,
    143,172-177).

The pure-Python implementation is the fallback/oracle; ``read_text_file``
dispatches to the native C++ parser (native/parser.cpp) when its shared
library has been built, which is ~40x faster on large files.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

Arr = np.ndarray


def parse_text_python(
    path: str,
    has_label: bool,
    ds: Optional[Sequence[int]] = None,
) -> Tuple[Arr, Arr, Arr, Arr, Arr, Arr, int, int]:
    """Single-pass Python parser.

    Returns ``(x_indptr, x_fid, x_idx, x_val, y_indptr, y_idx, n, f)`` where
    the ``x_*`` arrays are a row-major CSR of the feature triples and the
    ``y_*`` arrays a row-major CSR of the positive label ids.
    """
    x_indptr = [0]
    x_fid: list = []
    x_idx: list = []
    x_val: list = []
    y_indptr = [0]
    y_idx: list = []
    n = 0
    f = 0
    nds = len(ds) if ds is not None else 0

    with open(path, "r") as fh:
        for line in fh:
            toks = line.split()
            if not toks:
                # The reference counts blank lines as empty rows (getline
                # succeeds); replicate.
                x_indptr.append(len(x_fid))
                if has_label:
                    y_indptr.append(len(y_idx))
                continue
            start = 0
            if has_label:
                for lab in toks[0].split(","):
                    j = int(lab)
                    if j + 1 > n:
                        n = j + 1
                    y_idx.append(j)
                y_indptr.append(len(y_idx))
                start = 1
            for tok in toks[start:]:
                fid_s, idx_s, val_s = tok.split(":")
                fid = int(fid_s)
                if fid + 1 > f:
                    f = fid + 1
                idx = int(idx_s)
                if ds is not None and (fid >= nds or ds[fid] <= idx):
                    continue
                x_fid.append(fid)
                x_idx.append(idx)
                x_val.append(float(val_s))
            x_indptr.append(len(x_fid))

    return (
        np.asarray(x_indptr, dtype=np.int64),
        np.asarray(x_fid, dtype=np.int32),
        np.asarray(x_idx, dtype=np.int64),
        np.asarray(x_val, dtype=np.float64),
        np.asarray(y_indptr, dtype=np.int64),
        np.asarray(y_idx, dtype=np.int64),
        n,
        f,
    )


def _native_lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "libocffm.so")


_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    path = _native_lib_path()
    if not os.path.exists(path):
        _NATIVE = False
        return False
    try:
        from . import native_io

        _NATIVE = native_io
    except Exception:
        _NATIVE = False
    return _NATIVE


_CACHE_VERSION = 1
_CACHE_KEYS = ("x_indptr", "x_fid", "x_idx", "x_val", "y_indptr", "y_idx")


def _cache_path(path: str) -> str:
    return path + ".ocffm.npz"


def _cache_fresh(cpath: str, path: str, has_label: bool,
                 ds: Optional[Sequence[int]]):
    """Load the binary cache if it matches the source file + parse params."""
    if not os.path.exists(cpath):
        return None
    try:
        st = os.stat(path)
        z = np.load(cpath, allow_pickle=False)
        meta = z["meta"]
        if (int(meta[0]) != _CACHE_VERSION
                or int(meta[1]) != st.st_mtime_ns
                or int(meta[2]) != st.st_size
                or int(meta[3]) != int(has_label)):
            return None
        want_ds = np.asarray([] if ds is None else list(ds), dtype=np.int64)
        if not np.array_equal(z["ds"], want_ds):
            return None
        return tuple(z[k] for k in _CACHE_KEYS) + (
            int(meta[4]), int(meta[5]))
    except Exception:
        return None


def _cache_write(cpath: str, path: str, has_label: bool,
                 ds: Optional[Sequence[int]], out) -> None:
    """Atomic best-effort cache write (tmp + rename; failures are silent —
    read-only dataset directories just skip caching)."""
    try:
        st = os.stat(path)
        meta = np.asarray(
            [_CACHE_VERSION, st.st_mtime_ns, st.st_size, int(has_label),
             out[6], out[7]], dtype=np.int64)
        ds_arr = np.asarray([] if ds is None else list(ds), dtype=np.int64)
        tmp = cpath + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, meta=meta, ds=ds_arr,
                     **dict(zip(_CACHE_KEYS, out[:6])))
        os.replace(tmp, cpath)
    except Exception:
        pass


def read_text_file(
    path: str,
    has_label: bool,
    ds: Optional[Sequence[int]] = None,
    force_python: bool = False,
    cache: Optional[bool] = None,
):
    """Parse a data file, preferring the native C++ parser when available.

    Binary dataset cache (``<path>.ocffm.npz``): the parsed CSR arrays are
    saved next to the source after the first parse and binary-loaded on
    repeat runs — sweeps re-read the same train/item files for every grid
    point, and at web scale even the ~40x native parse is minutes of wasted
    work per run.  Keyed on source mtime+size and the parse params, written
    atomically, best-effort (read-only dirs just skip it).  Default from
    ``OCFFM_DATA_CACHE`` (on); ``force_python`` bypasses the cache so the
    parser-equivalence tests compare real parsers."""
    use_cache = cache
    if use_cache is None:
        use_cache = os.environ.get(
            "OCFFM_DATA_CACHE", "1").lower() not in ("0", "off", "false")
    if force_python:
        use_cache = False
    cpath = _cache_path(path)
    if use_cache:
        hit = _cache_fresh(cpath, path, has_label, ds)
        if hit is not None:
            return hit
    if not force_python:
        native = _load_native()
        if native:
            try:
                out = native.parse_text_native(path, has_label, ds)
                if use_cache:
                    _cache_write(cpath, path, has_label, ds, out)
                return out
            except Exception:
                pass
    out = parse_text_python(path, has_label, ds)
    if use_cache:
        _cache_write(cpath, path, has_label, ds, out)
    return out
