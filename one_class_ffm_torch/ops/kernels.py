"""Build, bind and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a``, one compiler per
source, all started together, and linked into one shared library with a
plain C interface, the first time a kernel is launched in a process; the
library is loaded with ``ctypes``.  It lives under ``build/torch_kernels/``
at the repository root, named by a hash of the sources, the shared header
and the compiler flags, so an edited source rebuilds and an unchanged one
loads at once.  A missing ``nvcc`` or a failed build raises: nothing falls
back to the plain versions.

Each launch wrapper checks device, dtype, shape and contiguity, allocates
its output with ``torch.empty``, launches on the current CUDA stream, raises
if ``cudaGetLastError()`` reports a refused launch, and adds one to its entry
in the launch counts.  Nothing here touches CUDA or ``nvcc`` at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from .layout import FeatureMajor

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "blocked_ops.cu", _PKG / "csrc" / "table_ops.cu",
           _PKG / "csrc" / "project_ops.cu")
HEADERS = (_PKG / "csrc" / "common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# one entry per launch wrapper: the three blocked passes of a cross solve,
# the four fused table-space passes of a small-D feature field (each runs
# its row stage and the shared X^T stage), the projection X W of a feature
# field (B8), and the general scatter X^T Z of a wide field (the X^T stage
# on its own)
KERNELS = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked",
           "pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl",
           "project", "scatter")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel since the last reset: a run reads them to show that
# its main path went through the kernels.
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # time the last build or load took


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of one_class_ffm_torch cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libocffm_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists; returns
    its path.  Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate() for proc in procs]
        for cmd, proc, (stdout, stderr) in zip(cmds, procs, outputs):
            _raise_if_failed(cmd, proc.returncode, stdout, stderr)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o",
                os.path.join(tmpdir, out.name), *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_if_failed(link, proc.returncode, proc.stdout, proc.stderr)
        # atomic: a concurrent loader never sees half a file
        os.replace(os.path.join(tmpdir, out.name), out)
    return out


def _raise_if_failed(cmd, returncode: int, stdout: str, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.ocffm_max_k.argtypes = []
    lib.ocffm_max_k.restype = i32
    lib.ocffm_pos_hv_blocked.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, f32, vp]
    lib.ocffm_pos_hv_blocked.restype = i32
    lib.ocffm_pos_scatter_blocked.argtypes = [
        i32, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_scatter_blocked.restype = i32
    lib.ocffm_pos_gap_blocked.argtypes = [
        i32, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_gap_blocked.restype = i32
    lib.ocffm_pos_hv_tbl_rows.argtypes = [
        i32, vp, vp, vp, i32, i32, vp, vp, vp, vp, vp, i64, i32, i32, i32,
        f32, vp]
    lib.ocffm_grad_cross_tbl_rows.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_hv_self_tbl_rows.argtypes = [
        i32, vp, vp, vp, i32, i32, vp, vp, vp, i64, i32, vp]
    lib.ocffm_grad_self_tbl_rows.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_xt_scatter.argtypes = [
        i32, vp, vp, vp, vp, i32, vp, i32, i32, vp, vp, vp]
    lib.ocffm_project.argtypes = [i32, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    for fn in (lib.ocffm_pos_hv_tbl_rows, lib.ocffm_grad_cross_tbl_rows,
               lib.ocffm_hv_self_tbl_rows, lib.ocffm_grad_self_tbl_rows,
               lib.ocffm_xt_scatter, lib.ocffm_project):
        fn.restype = i32
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


# ---------------------------------------------------------------------------
# launch wrappers (CUDA tensors only; ops/sparse_ops.py dispatches)
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream_rows(rows: torch.Tensor, own: torch.Tensor, block_rows: int):
    """Common checks on the (n_blocks, MAXC, k) stream and its owners."""
    if rows.device.type != "cuda":
        raise ValueError(f"rows must be a CUDA tensor, got {rows.device}")
    if rows.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {rows.dtype}")
    if rows.dim() != 3:
        raise ValueError(f"rows must be (n_blocks, MAXC, k), got "
                         f"{tuple(rows.shape)}")
    nb, maxc, k = rows.shape
    lib = load()
    if not 0 < k <= lib.ocffm_max_k():
        raise ValueError(f"k={k} outside the kernels' range "
                         f"(1..{lib.ocffm_max_k()})")
    if nb == 0 or maxc == 0:
        raise ValueError("empty blocked stream")
    if not 0 < block_rows < (1 << 31):
        raise ValueError(f"block_rows={block_rows}")
    _check("rows", rows, rows.dtype, (nb, maxc, k), rows.device)
    _check("own", own, torch.int32, (nb, maxc), rows.device)
    return lib, nb, maxc, k


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pos_hv_blocked(phi, rows, own, w_blk, dense_mat, num_out: int,
                   block_rows: int, w_scale: float = 1.0) -> torch.Tensor:
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    if num_out != nb * block_rows:
        raise ValueError(f"num_out={num_out} != n_blocks*block_rows="
                         f"{nb * block_rows}")
    dev, dt = rows.device, rows.dtype
    _check("phi", phi, dt, (num_out, k), dev)
    _check("w_blk", w_blk, dt, (nb, maxc), dev)
    _check("dense_mat", dense_mat, dt, (k, k), dev)
    out = torch.empty((num_out, k), dtype=dt, device=dev)
    err = lib.ocffm_pos_hv_blocked(
        _DTYPE_CODE[dt], phi.data_ptr(), rows.data_ptr(), own.data_ptr(),
        w_blk.data_ptr(), dense_mat.data_ptr(), out.data_ptr(), nb, maxc, k,
        block_rows, float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_blocked")
    _launches["pos_hv_blocked"] += 1
    return out


def pos_scatter_blocked(c_blk, rows, own, num_out: int,
                        block_rows: int) -> torch.Tensor:
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    if num_out != nb * block_rows:
        raise ValueError(f"num_out={num_out} != n_blocks*block_rows="
                         f"{nb * block_rows}")
    dev, dt = rows.device, rows.dtype
    _check("c_blk", c_blk, dt, (nb, maxc), dev)
    out = torch.empty((num_out, k), dtype=dt, device=dev)
    err = lib.ocffm_pos_scatter_blocked(
        _DTYPE_CODE[dt], c_blk.data_ptr(), rows.data_ptr(), own.data_ptr(),
        out.data_ptr(), nb, maxc, k, block_rows, _stream(dev))
    _raise_on(err, "pos_scatter_blocked")
    _launches["pos_scatter_blocked"] += 1
    return out


def pos_gap_blocked(dP, rows, own, block_rows: int) -> torch.Tensor:
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    _check("dP", dP, dt, (nb * block_rows, k), dev)
    out = torch.empty((nb * maxc,), dtype=dt, device=dev)
    err = lib.ocffm_pos_gap_blocked(
        _DTYPE_CODE[dt], dP.data_ptr(), rows.data_ptr(), own.data_ptr(),
        out.data_ptr(), nb, maxc, k, block_rows, _stream(dev))
    _raise_on(err, "pos_gap_blocked")
    _launches["pos_gap_blocked"] += 1
    return out


# ---------------------------------------------------------------------------
# fused table-space passes: a row stage, then the shared X^T stage
# ---------------------------------------------------------------------------


def _x_rows(x_idx, x_val, rows: int, dt, dev) -> int:
    """Checks the row-major field arrays (rows, p); returns p."""
    if x_idx.dim() != 2:
        raise ValueError(f"x_idx must be (rows, p), got {tuple(x_idx.shape)}")
    p = x_idx.shape[1]
    _check("x_idx", x_idx, torch.int32, (rows, p), dev)
    _check("x_val", x_val, dt, (rows, p), dev)
    return p


def _table(V, xt: FeatureMajor, dt, k: int, dev, name: str) -> int:
    """Checks the (d, k) table of a projecting pass against the field's
    feature-major list; returns d."""
    if V.dim() != 2:
        raise ValueError(f"V must be (d, k), got {tuple(V.shape)}")
    d = V.shape[0]
    _check("V", V, dt, (d, k), dev)
    if xt.feat_ptr.numel() - 1 != d:
        raise ValueError(f"{name}: V has {d} rows, the feature-major list "
                         f"{xt.feat_ptr.numel() - 1} features")
    return d


def _xt_scatter(lib, payload: torch.Tensor, xt: FeatureMajor,
                name: str) -> torch.Tensor:
    """(d, k) float32 = X^T payload through the feature-major list."""
    dev, dt = payload.device, payload.dtype
    rows, k = payload.shape
    if xt.n_rows != rows:
        raise ValueError(f"{name}: the feature-major list scatters from "
                         f"{xt.n_rows} rows, the payload has {rows}")
    nnz, n_chunks, d = xt.row.numel(), xt.chunk_ptr.numel() - 1, \
        xt.feat_ptr.numel() - 1
    _check("xt.row", xt.row, torch.int32, (nnz,), dev)
    _check("xt.val", xt.val, dt, (nnz,), dev)
    _check("xt.chunk_ptr", xt.chunk_ptr, torch.int32, (n_chunks + 1,), dev)
    _check("xt.feat_ptr", xt.feat_ptr, torch.int32, (d + 1,), dev)
    partial = torch.empty((max(n_chunks, 1), k), dtype=torch.float32,
                          device=dev)
    out = torch.empty((d, k), dtype=torch.float32, device=dev)
    err = lib.ocffm_xt_scatter(
        _DTYPE_CODE[dt], payload.data_ptr(), xt.row.data_ptr(),
        xt.val.data_ptr(), xt.chunk_ptr.data_ptr(), n_chunks,
        xt.feat_ptr.data_ptr(), d, k, partial.data_ptr(), out.data_ptr(),
        _stream(dev))
    _raise_on(err, name)
    return out


def pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
               block_rows: int, w_scale: float = 1.0) -> torch.Tensor:
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    num = nb * block_rows
    d = _table(V, xt, dt, k, dev, "pos_hv_tbl")
    p = _x_rows(x_idx, x_val, num, dt, dev)
    _check("w_blk", w_blk, dt, (nb, maxc), dev)
    _check("dense_mat", dense_mat, dt, (k, k), dev)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_pos_hv_tbl_rows(
        _DTYPE_CODE[dt], V.data_ptr(), x_idx.data_ptr(), x_val.data_ptr(), p,
        d, rows.data_ptr(), own.data_ptr(), w_blk.data_ptr(),
        dense_mat.data_ptr(), payload.data_ptr(), nb, maxc, k, block_rows,
        float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_tbl")
    out = _xt_scatter(lib, payload, xt, "pos_hv_tbl")
    _launches["pos_hv_tbl"] += 1
    return out


def grad_cross_tbl(xt, rows, own, c_blk, dense,
                   block_rows: int) -> torch.Tensor:
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    num = nb * block_rows
    _check("c_blk", c_blk, dt, (nb, maxc), dev)
    _check("dense", dense, dt, (num, k), dev)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_grad_cross_tbl_rows(
        _DTYPE_CODE[dt], c_blk.data_ptr(), rows.data_ptr(), own.data_ptr(),
        dense.data_ptr(), payload.data_ptr(), nb, maxc, k, block_rows,
        _stream(dev))
    _raise_on(err, "grad_cross_tbl")
    out = _xt_scatter(lib, payload, xt, "grad_cross_tbl")
    _launches["grad_cross_tbl"] += 1
    return out


def _rows_table(Q1: torch.Tensor):
    """Common checks on the (rows, k) Q1 of a self-block pass."""
    if Q1.device.type != "cuda":
        raise ValueError(f"Q1 must be a CUDA tensor, got {Q1.device}")
    if Q1.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {Q1.dtype}")
    if Q1.dim() != 2:
        raise ValueError(f"Q1 must be (rows, k), got {tuple(Q1.shape)}")
    rows, k = Q1.shape
    lib = load()
    if not 0 < k <= lib.ocffm_max_k():
        raise ValueError(f"k={k} outside the kernels' range "
                         f"(1..{lib.ocffm_max_k()})")
    _check("Q1", Q1, Q1.dtype, (rows, k), Q1.device)
    return lib, rows, k


def hv_self_tbl(V, x_idx, x_val, xt, Q1, dd) -> torch.Tensor:
    lib, num, k = _rows_table(Q1)
    dev, dt = Q1.device, Q1.dtype
    d = _table(V, xt, dt, k, dev, "hv_self_tbl")
    p = _x_rows(x_idx, x_val, num, dt, dev)
    _check("dd", dd, dt, (num,), dev)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_hv_self_tbl_rows(
        _DTYPE_CODE[dt], V.data_ptr(), x_idx.data_ptr(), x_val.data_ptr(), p,
        d, Q1.data_ptr(), dd.data_ptr(), payload.data_ptr(), num, k,
        _stream(dev))
    _raise_on(err, "hv_self_tbl")
    out = _xt_scatter(lib, payload, xt, "hv_self_tbl")
    _launches["hv_self_tbl"] += 1
    return out


def grad_self_tbl(xt, Q1, zdense, own, c_blk,
                  block_rows: int) -> torch.Tensor:
    lib, num, k = _rows_table(Q1)
    dev, dt = Q1.device, Q1.dtype
    if own.dim() != 2 or not 0 < block_rows < (1 << 31):
        raise ValueError(f"own must be (n_blocks, MAXC) and block_rows "
                         f"positive, got {tuple(own.shape)}, {block_rows}")
    nb, maxc = own.shape
    if nb * block_rows != num or maxc == 0:
        raise ValueError(f"Q1 has {num} rows, the layout {nb} blocks of "
                         f"{block_rows} rows x MAXC {maxc}")
    _check("own", own, torch.int32, (nb, maxc), dev)
    _check("c_blk", c_blk, dt, (nb, maxc), dev)
    _check("zdense", zdense, dt, (num,), dev)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_grad_self_tbl_rows(
        _DTYPE_CODE[dt], Q1.data_ptr(), zdense.data_ptr(), own.data_ptr(),
        c_blk.data_ptr(), payload.data_ptr(), nb, maxc, k, block_rows,
        _stream(dev))
    _raise_on(err, "grad_self_tbl")
    out = _xt_scatter(lib, payload, xt, "grad_self_tbl")
    _launches["grad_self_tbl"] += 1
    return out


# ---------------------------------------------------------------------------
# the projection of a feature field (B8) and the general scatter
# ---------------------------------------------------------------------------


def _table_dtype(name: str, t: torch.Tensor):
    """Common checks on a (rows, k) storage tensor; returns (lib, k)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-d, got {tuple(t.shape)}")
    k = t.shape[1]
    lib = load()
    if not 0 < k <= lib.ocffm_max_k():
        raise ValueError(f"k={k} outside the kernels' range "
                         f"(1..{lib.ocffm_max_k()})")
    _check(name, t, t.dtype, tuple(t.shape), t.device)
    return lib, k


def project(idx, val, W) -> torch.Tensor:
    """(rows, k) storage = X W (B8)."""
    lib, k = _table_dtype("W", W)
    dev, dt = W.device, W.dtype
    if idx.dim() != 2:
        raise ValueError(f"idx must be (rows, p), got {tuple(idx.shape)}")
    rows, p = idx.shape
    _check("idx", idx, torch.int32, (rows, p), dev)
    _check("val", val, dt, (rows, p), dev)
    out = torch.empty((rows, k), dtype=dt, device=dev)
    err = lib.ocffm_project(_DTYPE_CODE[dt], idx.data_ptr(), val.data_ptr(),
                            W.data_ptr(), out.data_ptr(), rows, p,
                            W.shape[0], k, _stream(dev))
    _raise_on(err, "project")
    _launches["project"] += 1
    return out


def scatter(xt: FeatureMajor, Z) -> torch.Tensor:
    """(d, k) storage = X^T Z: the X^T stage sums at float32, then one cast
    to storage (a no-op at float32)."""
    lib, _ = _table_dtype("Z", Z)
    out = _xt_scatter(lib, Z, xt, "scatter")
    _launches["scatter"] += 1
    return out.to(Z.dtype)
