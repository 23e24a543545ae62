"""ctypes binding for the native C++ text parser (native/parser.cpp).

A copy of ``one_class_ffm_tpu/data/native_io.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Same return contract as ``io.parse_text_python``; dispatched to by
``io.read_text_file`` when ``native/libocffm.so`` exists (build with
``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np


class _ParseCounts(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("x_nnz", ctypes.c_int64),
        ("y_nnz", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("f", ctypes.c_int32),
    ]


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libocffm.so")
    lib = ctypes.CDLL(path)
    lib.ocffm_count.restype = ctypes.c_int
    lib.ocffm_count.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(_ParseCounts),
    ]
    lib.ocffm_fill.restype = ctypes.c_int
    lib.ocffm_fill.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(_ParseCounts),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_text_native(
    path: str,
    has_label: bool,
    ds: Optional[Sequence[int]] = None,
):
    lib = _load()
    counts = _ParseCounts()
    if ds is not None:
        ds_arr = np.ascontiguousarray(np.asarray(ds, dtype=np.int64))
        ds_ptr = _as_ptr(ds_arr, ctypes.c_int64)
        n_ds = len(ds_arr)
    else:
        ds_ptr = None
        n_ds = 0
    rc = lib.ocffm_count(
        path.encode(), int(has_label), ds_ptr, n_ds, ctypes.byref(counts)
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"malformed data file: {path} (rc={rc})")

    rows = counts.rows
    x_indptr = np.zeros(rows + 1, dtype=np.int64)
    x_fid = np.empty(counts.x_nnz, dtype=np.int32)
    x_idx = np.empty(counts.x_nnz, dtype=np.int64)
    x_val = np.empty(counts.x_nnz, dtype=np.float64)
    y_indptr = np.zeros((rows + 1) if has_label else 1, dtype=np.int64)
    y_idx = np.empty(counts.y_nnz, dtype=np.int64)

    rc = lib.ocffm_fill(
        path.encode(),
        int(has_label),
        ds_ptr,
        n_ds,
        ctypes.byref(counts),
        _as_ptr(x_indptr, ctypes.c_int64),
        _as_ptr(x_fid, ctypes.c_int32),
        _as_ptr(x_idx, ctypes.c_int64),
        _as_ptr(x_val, ctypes.c_double),
        _as_ptr(y_indptr, ctypes.c_int64),
        _as_ptr(y_idx, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError(f"malformed data file on fill: {path} (rc={rc})")
    if not has_label:
        y_indptr = np.zeros(1, dtype=np.int64)
    return (
        x_indptr,
        x_fid,
        x_idx,
        x_val,
        y_indptr,
        y_idx,
        int(counts.n),
        int(counts.f),
    )


def read_model_body_native(path: str, offset: int, k: int):
    """Parse the model body (lines ``N,f1,f2,row v1 .. vk`` after byte
    ``offset``) via the C reader.  Returns (name_codes, f1, f2, row, vals)
    flat arrays (name code 0 = W, 1 = H) or None when the native lib is
    unavailable."""
    try:
        lib = _load()
    except OSError:
        return None
    if not hasattr(lib, "ocffm_read_model"):
        return None
    lib.ocffm_read_model.restype = ctypes.c_int
    lib.ocffm_read_model.argtypes = [
        ctypes.c_char_p,
        ctypes.c_longlong,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    n = ctypes.c_int64(0)
    none = ctypes.POINTER(ctypes.c_int8)()
    rc = lib.ocffm_read_model(
        path.encode(), offset, k, ctypes.byref(n), none,
        ctypes.POINTER(ctypes.c_int32)(), ctypes.POINTER(ctypes.c_int32)(),
        ctypes.POINTER(ctypes.c_int64)(), ctypes.POINTER(ctypes.c_double)(),
        0,
    )
    if rc != 0:
        raise ValueError(f"malformed model file: {path} (rc={rc})")
    n_rows = n.value
    name = np.empty(n_rows, dtype=np.int8)
    f1 = np.empty(n_rows, dtype=np.int32)
    f2 = np.empty(n_rows, dtype=np.int32)
    row = np.empty(n_rows, dtype=np.int64)
    vals = np.empty((n_rows, k), dtype=np.float64)
    rc = lib.ocffm_read_model(
        path.encode(), offset, k, ctypes.byref(n),
        _as_ptr(name, ctypes.c_int8), _as_ptr(f1, ctypes.c_int32),
        _as_ptr(f2, ctypes.c_int32), _as_ptr(row, ctypes.c_int64),
        _as_ptr(vals, ctypes.c_double), 1,
    )
    if rc != 0:
        raise ValueError(f"malformed model file on fill: {path} (rc={rc})")
    return name, f1, f2, row, vals


def write_block_native(path: str, name: str, f1: int, f2: int, table) -> bool:
    """Append one model block via the C writer; returns False if unavailable."""
    try:
        lib = _load()
    except OSError:
        return False
    if not hasattr(lib, "ocffm_write_block"):
        return False
    lib.ocffm_write_block.restype = ctypes.c_int
    lib.ocffm_write_block.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    arr = np.ascontiguousarray(table, dtype=np.float64)
    rc = lib.ocffm_write_block(
        path.encode(), name.encode(), f1, f2,
        _as_ptr(arr, ctypes.c_double), arr.shape[0], arr.shape[1],
    )
    return rc == 0
