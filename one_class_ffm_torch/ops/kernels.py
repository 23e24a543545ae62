"""Build, bind and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, the first time a kernel is launched in a process,
and loaded with ``ctypes``.  The library lives under ``build/torch_kernels/``
at the repository root, named by a hash of the sources and the compiler
flags, so an edited source rebuilds and an unchanged one loads at once.  A
missing ``nvcc`` or a failed build raises: nothing falls back to the plain
versions.

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

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "blocked_ops.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

KERNELS = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked")
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
    for src in SOURCES:
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


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
