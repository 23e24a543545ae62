"""Build, bind and count the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a``, one compiler per
source, all started together, and linked into one shared library with a
plain C interface, the first time a kernel is launched in a process; the
library is loaded with ``ctypes``.  It lives under ``build/torch_kernels/``
at the repository root, named by a hash of the sources, the shared header
and the compiler flags, so an edited source rebuilds and an unchanged one
loads at once.  A missing ``nvcc`` or a failed build raises: nothing falls
back to the plain versions.

Each launch wrapper checks device, dtype, shape and contiguity (a static
feature-major list once per list), allocates its output with
``torch.empty``, launches on the current CUDA stream, raises if
``cudaGetLastError()`` reports a refused launch, and adds one to its entry
in the launch counts.  Nothing here touches CUDA or ``nvcc`` at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .layout import FeatureMajor, seg_sum_lanes, xt_plan

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "blocked_ops.cu", "table_ops.cu", "project_ops.cu", "hv_variants.cu",
    "coo_ops.cu", "cg_ops.cu", "topk_ops.cu"))
HEADERS = (_PKG / "csrc" / "common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# one entry per launch wrapper: the three blocked passes of a cross solve,
# the four fused table-space passes of a small-D feature field (each runs
# its row stage and the shared X^T stage), the projection X W of a feature
# field (B8), the general scatter X^T Z of a wide field (the X^T stage on
# its own, through X or X^2), the three gradient passes with the Jacobi
# diagonal's second output, the two Hv variants of hv_pack_bench (B9,
# B10), the positive passes of a side without a blocked layout (one pass
# over the side's list of the positive stream, coo_ops.cu: the gradient's
# scatter, with the Jacobi payload from the same read or that payload
# alone, the self blocks' per-row sums, and the fused cross Hv), and the
# stream's gather-and-dot pos_dot (the residual refresh, a COO side's gaps),
# the CG recurrence of a Newton solve (cg_ops.cu: its start, and one
# iteration after the Hv with the stop test on the card), and each row's
# top K of a score matrix (topk_ops.cu: ranking and the evaluator's top-K)
KERNELS = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked",
           "pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl",
           "project", "scatter", "pos_scatter_blocked_diag",
           "grad_cross_tbl_diag", "grad_self_tbl_diag", "pos_hv_packed",
           "pos_hv_blocked_g", "pos_scatter", "pos_scatter_pair",
           "pos_seg_sum", "pos_hv_coo", "pos_dot", "cg_init", "cg_step",
           "topk_rows")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches per kernel since the last reset: a run reads them to show that
# its main path went through the kernels.
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
_lib: Optional[ctypes.CDLL] = None
_max_k: int = 0  # the largest k the kernels take (the library's ocffm_max_k)
build_seconds: float = 0.0  # time the last build or load took


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def count_launches(delta: Dict[str, int]) -> None:
    """Add launches made outside the wrappers: a CUDA graph's replay counts
    the launches its capture recorded (its capture launched nothing)."""
    for name, n in delta.items():
        _launches[name] += n


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
    global _lib, _max_k, build_seconds
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
        i32, vp, vp, vp, vp, f32, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_scatter_blocked.restype = i32
    lib.ocffm_pos_gap_blocked.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_gap_blocked.restype = i32
    lib.ocffm_pos_hv_tbl_rows.argtypes = [
        i32, vp, vp, vp, i32, i32, vp, vp, vp, vp, vp, i64, i32, i32, i32,
        f32, vp]
    lib.ocffm_grad_cross_tbl_rows.argtypes = [
        i32, vp, vp, f32, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_hv_self_tbl_rows.argtypes = [
        i32, vp, vp, vp, i32, i32, vp, vp, vp, i64, i32, vp]
    lib.ocffm_grad_self_tbl_rows.argtypes = [
        i32, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.ocffm_xt_scatter.argtypes = [
        i32, vp, vp, i32, vp, vp, vp, vp, i32, vp, vp, i32, vp, vp, i32, vp,
        vp, vp]
    lib.ocffm_project.argtypes = [i32, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_hv_packed.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i64, i32, i32, f32, vp]
    lib.ocffm_pos_hv_blocked_g.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, f32, vp]
    lib.ocffm_coo_list.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, vp, f32, vp, vp, vp, i32, vp, vp, i32,
        vp, vp, vp, vp, vp, i32, i32, vp]
    lib.ocffm_pos_dot.argtypes = [i32, vp, vp, i32, vp, vp, i32, vp, i64, i32,
                                  vp]
    lib.ocffm_cg_init.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, i64,
                                  i32, i32, i32, f32, i32, vp]
    lib.ocffm_cg_step.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, i64,
                                  i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.ocffm_cg_blocks.argtypes = [i32, i32, i32, i32, i32,
                                    ctypes.POINTER(i32)]
    lib.ocffm_topk_segs.argtypes = [i32, i64, i32, i32]
    lib.ocffm_topk_rows.argtypes = [i32, vp, i64, i64, i32, i32, i32, vp, vp,
                                    vp, vp, vp]
    for fn in (lib.ocffm_pos_hv_tbl_rows, lib.ocffm_grad_cross_tbl_rows,
               lib.ocffm_hv_self_tbl_rows, lib.ocffm_grad_self_tbl_rows,
               lib.ocffm_xt_scatter, lib.ocffm_project,
               lib.ocffm_pos_hv_packed, lib.ocffm_pos_hv_blocked_g,
               lib.ocffm_coo_list, lib.ocffm_pos_dot, lib.ocffm_cg_init,
               lib.ocffm_cg_step, lib.ocffm_cg_blocks, lib.ocffm_topk_segs,
               lib.ocffm_topk_rows):
        fn.restype = i32
    _lib = lib
    _max_k = lib.ocffm_max_k()
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
    if not 0 < k <= _max_k:
        raise ValueError(f"k={k} outside the kernels' range (1..{_max_k})")
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
    """The current CUDA stream's handle (the raw lookup where this torch
    build has it: a launch's host time is part of a short kernel's cost)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device pointer, or NULL for an absent optional input."""
    return None if t is None else t.data_ptr()


def _hv_out(phi, dense_mat, num_out: int, nb: int, k: int, block_rows: int,
            dev, dt) -> torch.Tensor:
    """Checks B1's per-row inputs; returns the output to fill."""
    if num_out != nb * block_rows:
        raise ValueError(f"num_out={num_out} != n_blocks*block_rows="
                         f"{nb * block_rows}")
    _check("phi", phi, dt, (num_out, k), dev)
    _check("dense_mat", dense_mat, dt, (k, k), dev)
    return torch.empty((num_out, k), dtype=dt, device=dev)


def _runs(own: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Each row's run of slots (``layout.row_runs``) computed on the device
    from ``own``, for a caller that has no static copy."""
    nb = own.shape[0]
    keys = torch.arange(block_rows + 1, device=own.device,
                        dtype=own.dtype).expand(nb, -1).contiguous()
    return torch.searchsorted(own, keys).to(torch.int32)


def _row_runs(runs, own: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The (n_blocks, block_rows + 1) row runs a kernel reads in place of
    ``own``: the static ``layout.row_runs`` the caller passes, checked, or
    found on the device."""
    if runs is None:
        runs = _runs(own, block_rows)
    _check("runs", runs, torch.int32, (own.shape[0], block_rows + 1),
           own.device)
    return runs


def pos_hv_blocked(phi, rows, own, w_blk, dense_mat, num_out: int,
                   block_rows: int, w_scale: float = 1.0,
                   runs=None) -> torch.Tensor:
    """B1; the kernel reads each row's run from ``runs`` (see
    ``_row_runs``), not ``own``."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    _check("w_blk", w_blk, dt, (nb, maxc), dev)
    out = _hv_out(phi, dense_mat, num_out, nb, k, block_rows, dev, dt)
    runs = _row_runs(runs, own, block_rows)
    err = lib.ocffm_pos_hv_blocked(
        _DTYPE_CODE[dt], phi.data_ptr(), rows.data_ptr(), runs.data_ptr(),
        w_blk.data_ptr(), dense_mat.data_ptr(), out.data_ptr(), nb, maxc, k,
        block_rows, float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_blocked")
    _launches["pos_hv_blocked"] += 1
    return out


def _scatter_blocked(name: str, c_blk, rows, own, num_out: int,
                     block_rows: int, w_blk=None, wq_scale: float = 1.0,
                     runs=None):
    """B2; with ``w_blk`` also the Jacobi payload, from one launch.  The
    kernel reads each row's run from ``runs`` (see ``_row_runs``).  Returns
    (zpos, posq), posq None without w_blk."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    if num_out != nb * block_rows:
        raise ValueError(f"num_out={num_out} != n_blocks*block_rows="
                         f"{nb * block_rows}")
    dev, dt = rows.device, rows.dtype
    _check("c_blk", c_blk, dt, (nb, maxc), dev)
    runs = _row_runs(runs, own, block_rows)
    out = torch.empty((num_out, k), dtype=dt, device=dev)
    outq = None
    if w_blk is not None:
        _check("w_blk", w_blk, dt, (nb, maxc), dev)
        outq = torch.empty((num_out, k), dtype=dt, device=dev)
    err = lib.ocffm_pos_scatter_blocked(
        _DTYPE_CODE[dt], c_blk.data_ptr(), rows.data_ptr(), runs.data_ptr(),
        _ptr(w_blk), float(wq_scale), out.data_ptr(), _ptr(outq), nb, maxc,
        k, block_rows, _stream(dev))
    _raise_on(err, name)
    _launches[name] += 1
    return out, outq


def pos_scatter_blocked(c_blk, rows, own, num_out: int, block_rows: int,
                        runs=None) -> torch.Tensor:
    return _scatter_blocked("pos_scatter_blocked", c_blk, rows, own, num_out,
                            block_rows, runs=runs)[0]


def pos_scatter_blocked_diag(c_blk, rows, own, num_out: int, block_rows: int,
                             w_blk, wq_scale: float = 1.0, runs=None):
    """(zpos, posq) from one read of the stream (B2 with the Jacobi w_blk
    payload)."""
    return _scatter_blocked("pos_scatter_blocked_diag", c_blk, rows, own,
                            num_out, block_rows, w_blk, wq_scale, runs)


def pos_gap_blocked(dP, rows, own, block_rows: int,
                    runs=None) -> torch.Tensor:
    """B3: gap_t = storage(<dP[own_t], rows_t>) flat in slot order, every
    slot written, pads +0 (see ``_gap_into``)."""
    out = torch.empty((own.numel(),), dtype=rows.dtype, device=rows.device)
    _gap_into(out, dP, rows, own, block_rows, runs)
    _launches["pos_gap_blocked"] += 1
    return out


def _gap_into(out, dP, rows, own, block_rows: int, runs=None) -> None:
    """B3 into ``out`` (n_blocks * MAXC,): the staged kernel reads each
    row's run from ``runs`` (see ``_row_runs``), the plain-load path (k >
    32, MAXC % 8 != 0, unaligned rows) reads ``own``."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    _check("dP", dP, dt, (nb * block_rows, k), dev)
    _check("out", out, dt, (nb * maxc,), dev)
    runs = _row_runs(runs, own, block_rows)
    err = lib.ocffm_pos_gap_blocked(
        _DTYPE_CODE[dt], dP.data_ptr(), rows.data_ptr(), own.data_ptr(),
        runs.data_ptr(), out.data_ptr(), nb, maxc, k, block_rows,
        _stream(dev))
    _raise_on(err, "pos_gap_blocked")


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


class _XtPlan:
    """A feature-major list as one launch of the X^T kernel (or, for a list
    of the positive stream, of coo_list_kernel) reads it: the device
    pointers of its arrays and plan, its sizes, and the launch's scratch:
    tickets (one int per feature, zero between launches) and partial rows
    per width.  The scratch is shared by the list's launches, which run in
    order on the one stream of a solve."""

    def __init__(self, xt: FeatureMajor, vals, plan, dev):
        combine, chunk_dst, slot_feat = plan
        self.xt, self.plan, self.dev = xt, plan, dev
        self.n_chunks = xt.chunk_ptr.numel() - 1
        self.d = xt.feat_ptr.numel() - 1
        self.n_combine = combine.numel()
        # a partial row for each chunk outside the single-chunk features,
        # each of which has exactly one chunk
        self.n_partial = self.n_chunks - (self.d - self.n_combine)
        self.tickets = torch.zeros(self.d, dtype=torch.int32, device=dev)
        self.ptrs = tuple(_ptr(t) for t in (
            xt.row, vals, xt.chunk_ptr, chunk_dst, xt.feat_ptr, combine,
            slot_feat, self.tickets))
        self._partial: Dict[int, torch.Tensor] = {}

    def partial(self, k: int) -> torch.Tensor:
        p = self._partial.get(k)
        if p is None:
            p = self._partial[k] = torch.empty(
                (max(self.n_partial, 1), k), dtype=torch.float32,
                device=self.dev)
        return p


# Feature-major lists already checked, by (id, dtype, device, squared); the
# plan holds the list, so that its id stays its own.  The lists are static,
# so a solver's checks run once, not on every call.
_xt_checked: Dict[tuple, _XtPlan] = {}
# while a CUDA graph is captured: every plan its launches read (``hold_plans``)
_held: Optional[List[_XtPlan]] = None


@contextmanager
def hold_plans():
    """Collect every list plan the launches inside the block read.  A CUDA
    graph captured there writes the plans' scratch (tickets, partial rows)
    at every replay, so its owner keeps them: the cache above drops its
    entries at 64 lists, and a freed scratch would be written by a replay
    without an error."""
    global _held
    saved, _held = _held, []
    try:
        yield _held
    finally:
        _held = saved


def _hold(plan: _XtPlan) -> _XtPlan:
    if _held is not None:
        _held.append(plan)
    return plan


def _xt_inputs(xt: FeatureMajor, dt, dev, squared: bool,
               name: str) -> _XtPlan:
    """The launch inputs of a feature-major list, checked once per list;
    the plan is derived from ``feat_ptr`` (``layout.xt_plan``) for a list
    built without it."""
    key = (id(xt), dt, dev, squared)
    hit = _xt_checked.get(key)
    if hit is not None and hit.xt is xt:
        return _hold(hit)
    if xt.val is None or xt.pos is not None:
        raise ValueError(f"{name}: a list of the positive stream, not of a "
                         "field's X")
    vals = xt.val
    if squared:
        if xt.val_sq is None:
            raise ValueError(f"{name}: the feature-major list carries no "
                             "squared values (val_sq)")
        vals = xt.val_sq
    plan = (xt.combine, xt.chunk_dst, xt.slot_feat)
    if any(a is None for a in plan):
        plan = tuple(torch.from_numpy(a).to(dev) for a in
                     xt_plan(xt.feat_ptr.cpu().numpy()))
    _check("xt.val_sq" if squared else "xt.val", vals, dt,
           (xt.row.numel(),), dev)
    return _hold(_plan_of(key, xt, vals, plan, dev))


def _plan_of(key, xt: FeatureMajor, vals, plan, dev, cls=None) -> _XtPlan:
    """Checks a list's index arrays and plan; caches and returns its
    launch inputs (a ``cls``, by default ``_XtPlan``)."""
    nnz, n_chunks, d = xt.row.numel(), xt.chunk_ptr.numel() - 1, \
        xt.feat_ptr.numel() - 1
    combine, chunk_dst, slot_feat = plan
    _check("xt.row", xt.row, torch.int32, (nnz,), dev)
    _check("xt.chunk_ptr", xt.chunk_ptr, torch.int32, (n_chunks + 1,), dev)
    _check("xt.feat_ptr", xt.feat_ptr, torch.int32, (d + 1,), dev)
    _check("xt.chunk_dst", chunk_dst, torch.int32, (n_chunks,), dev)
    _check("xt.combine", combine, torch.int32, (combine.numel(),), dev)
    out = (cls or _XtPlan)(xt, vals, plan, dev)
    _check("xt.slot_feat", slot_feat, torch.int32, (out.n_partial,), dev)
    if len(_xt_checked) >= 64:
        _xt_checked.clear()
    _xt_checked[key] = out
    return out


def _xt_scatter(lib, payload: torch.Tensor, xt: FeatureMajor,
                name: str, squared: bool = False,
                scale: Optional[torch.Tensor] = None,
                payload_sq: bool = False) -> torch.Tensor:
    """(d, k) float32 = X^T payload (X^2 with ``squared``: the list's
    squared values) through the feature-major list and its plan; with
    ``scale`` (rows,) the payload row of an entry is storage(scale[row] *
    payload[row]) (B6, B7), with ``payload_sq`` as well
    storage(storage(scale[row] * payload[row]) * payload[row]) (B7's Jacobi
    payload), formed in the kernel."""
    dev, dt = payload.device, payload.dtype
    rows, k = payload.shape
    if xt.n_rows != rows:
        raise ValueError(f"{name}: the feature-major list scatters from "
                         f"{xt.n_rows} rows, the payload has {rows}")
    if scale is not None:
        _check("scale", scale, dt, (rows,), dev)
    elif payload_sq:
        raise ValueError(f"{name}: a squared payload needs its scale")
    p = _xt_inputs(xt, dt, dev, squared, name)
    source = 0 if scale is None else 2 if payload_sq else 1
    return _xt_launch(lib, p, payload, scale, source, k, dt, dev, name)


def _xt_launch(lib, p: _XtPlan, payload, scale, source: int, k: int, dt,
               dev, name: str) -> torch.Tensor:
    """One launch of the X^T kernel over a checked list: the (d, k) float32
    sums of the entries' terms of ``source`` (table_ops.cu
    ocffm_xt_scatter)."""
    row, vals, chunk_ptr, chunk_dst, feat_ptr, combine, slot_feat, \
        tickets = p.ptrs
    out = torch.empty((p.d, k), dtype=torch.float32, device=dev)
    err = lib.ocffm_xt_scatter(
        _DTYPE_CODE[dt], _ptr(payload), _ptr(scale), source, row, vals,
        chunk_ptr, chunk_dst, p.n_chunks, feat_ptr, combine, p.n_combine,
        slot_feat, tickets, k, p.partial(k).data_ptr(), out.data_ptr(),
        _stream(dev))
    _raise_on(err, name)
    return out


def pos_hv_tbl(V, x_idx, x_val, xt, rows, own, w_blk, dense_mat,
               block_rows: int, w_scale: float = 1.0,
               runs=None) -> torch.Tensor:
    """B4: its row stage reads each row's run from ``runs`` (see
    ``_row_runs``), then the X^T stage."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    num = nb * block_rows
    d = _table(V, xt, dt, k, dev, "pos_hv_tbl")
    p = _x_rows(x_idx, x_val, num, dt, dev)
    _check("w_blk", w_blk, dt, (nb, maxc), dev)
    _check("dense_mat", dense_mat, dt, (k, k), dev)
    runs = _row_runs(runs, own, block_rows)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_pos_hv_tbl_rows(
        _DTYPE_CODE[dt], V.data_ptr(), x_idx.data_ptr(), x_val.data_ptr(), p,
        d, rows.data_ptr(), runs.data_ptr(), w_blk.data_ptr(),
        dense_mat.data_ptr(), payload.data_ptr(), nb, maxc, k, block_rows,
        float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_tbl")
    out = _xt_scatter(lib, payload, xt, "pos_hv_tbl")
    _launches["pos_hv_tbl"] += 1
    return out


def _grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows: int,
                    w_blk=None, wq_scale: float = 1.0, runs=None):
    """B5's row stage (B2's kernel body with the dense term; one launch,
    both payloads with ``w_blk``) reads each row's run from ``runs`` (see
    ``_row_runs``), then the X^T stage of each payload: through X, and
    through X^2 for the Jacobi payload.  Returns the (d, k) float32
    results, Qt None without w_blk."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    dev, dt = rows.device, rows.dtype
    num = nb * block_rows
    _check("c_blk", c_blk, dt, (nb, maxc), dev)
    _check("dense", dense, dt, (num, k), dev)
    runs = _row_runs(runs, own, block_rows)
    payload = torch.empty((num, k), dtype=dt, device=dev)
    payload_q = None
    if w_blk is not None:
        _check("w_blk", w_blk, dt, (nb, maxc), dev)
        payload_q = torch.empty((num, k), dtype=dt, device=dev)
    err = lib.ocffm_grad_cross_tbl_rows(
        _DTYPE_CODE[dt], c_blk.data_ptr(), _ptr(w_blk), float(wq_scale),
        rows.data_ptr(), runs.data_ptr(), dense.data_ptr(),
        payload.data_ptr(), _ptr(payload_q), nb, maxc, k, block_rows,
        _stream(dev))
    _raise_on(err, "grad_cross_tbl")
    gt = _xt_scatter(lib, payload, xt, "grad_cross_tbl")
    if payload_q is None:
        return gt, None
    return gt, _xt_scatter(lib, payload_q, xt, "grad_cross_tbl", True)


def grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows: int,
                   runs=None) -> torch.Tensor:
    gt, _ = _grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows,
                            runs=runs)
    _launches["grad_cross_tbl"] += 1
    return gt


def grad_cross_tbl_diag(xt, rows, own, c_blk, dense, block_rows: int, w_blk,
                        wq_scale: float = 1.0, runs=None):
    """(Gt, Qt): B5 with the Jacobi w_blk output."""
    out = _grad_cross_tbl(xt, rows, own, c_blk, dense, block_rows, w_blk,
                          wq_scale, runs)
    _launches["grad_cross_tbl_diag"] += 1
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
    if not 0 < k <= _max_k:
        raise ValueError(f"k={k} outside the kernels' range (1..{_max_k})")
    _check("Q1", Q1, Q1.dtype, (rows, k), Q1.device)
    return lib, rows, k


def hv_self_tbl(V, x_idx, x_val, xt, Q1, dd) -> torch.Tensor:
    """B6: its row stage writes each row's scale s (rows,) of Q1[row], its
    X^T stage gathers storage(s[row] * Q1[row]) per entry."""
    lib, num, k = _rows_table(Q1)
    dev, dt = Q1.device, Q1.dtype
    d = _table(V, xt, dt, k, dev, "hv_self_tbl")
    p = _x_rows(x_idx, x_val, num, dt, dev)
    _check("dd", dd, dt, (num,), dev)
    s = torch.empty((num,), dtype=dt, device=dev)
    err = lib.ocffm_hv_self_tbl_rows(
        _DTYPE_CODE[dt], V.data_ptr(), x_idx.data_ptr(), x_val.data_ptr(), p,
        d, Q1.data_ptr(), dd.data_ptr(), s.data_ptr(), num, k, _stream(dev))
    _raise_on(err, "hv_self_tbl")
    out = _xt_scatter(lib, Q1, xt, "hv_self_tbl", scale=s)
    _launches["hv_self_tbl"] += 1
    return out


def _grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows: int, dd=None,
                   runs=None):
    """B7's row stage writes each row's scale zb (rows,) of Q1[row] from its
    run of ``c_blk`` (``runs``, see ``_row_runs``); the X^T stage forms
    storage(zb[row] * Q1[row]) per entry, and with ``dd`` the Jacobi
    payload storage(storage(dd[row] * Q1[row]) * Q1[row]) per entry through
    X^2."""
    lib, num, _ = _rows_table(Q1)
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
    if dd is not None:
        _check("dd", dd, dt, (num,), dev)
    runs = _row_runs(runs, own, block_rows)
    zb = torch.empty((num,), dtype=dt, device=dev)
    err = lib.ocffm_grad_self_tbl_rows(
        _DTYPE_CODE[dt], zdense.data_ptr(), runs.data_ptr(), c_blk.data_ptr(),
        zb.data_ptr(), num, maxc, block_rows, _stream(dev))
    _raise_on(err, "grad_self_tbl")
    gt = _xt_scatter(lib, Q1, xt, "grad_self_tbl", scale=zb)
    if dd is None:
        return gt, None
    return gt, _xt_scatter(lib, Q1, xt, "grad_self_tbl", True, scale=dd,
                           payload_sq=True)


def grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows: int,
                  runs=None) -> torch.Tensor:
    gt, _ = _grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows,
                           runs=runs)
    _launches["grad_self_tbl"] += 1
    return gt


def grad_self_tbl_diag(xt, Q1, zdense, own, c_blk, block_rows: int, dd,
                       runs=None):
    """(Gt, Dq): B7 with the Jacobi dd output."""
    out = _grad_self_tbl(xt, Q1, zdense, own, c_blk, block_rows, dd, runs)
    _launches["grad_self_tbl_diag"] += 1
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
    if not 0 < k <= _max_k:
        raise ValueError(f"k={k} outside the kernels' range (1..{_max_k})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
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


def scatter(xt: FeatureMajor, Z, squared: bool = False) -> torch.Tensor:
    """(d, k) storage = X^T Z (X^2 with ``squared``): the X^T stage sums at
    float32, then one cast to storage (a no-op at float32)."""
    lib, _ = _table_dtype("Z", Z)
    out = _xt_scatter(lib, Z, xt, "scatter", squared)
    _launches["scatter"] += 1
    return out if Z.dtype == torch.float32 else out.to(Z.dtype)


# ---------------------------------------------------------------------------
# the positive passes of a COO side: one pass over its list of the positive
# stream (coo_ops.cu coo_list_kernel), and the stream's gather-and-dot
# ---------------------------------------------------------------------------

# the kernel's sources (coo_ops.cu CooSrc)
_COEF, _PAIR, _SQ, _HV, _SUM = range(5)


class _CooPlan(_XtPlan):
    """A COO side's list (``layout.coo_list``) as coo_list_kernel reads it:
    the X^T plan's arrays and scratch, the entries' stream positions and
    weights in list order (``val``, where the list has them), each
    chunk's row, and the lanes a chunk of its width-1 sums
    (``layout.seg_sum_lanes``)."""

    def __init__(self, coo: FeatureMajor, vals, plan, dev):
        super().__init__(coo, vals, plan, dev)
        counts = (coo.feat_ptr[1:] - coo.feat_ptr[:-1]).long()
        self.chunk_row = torch.repeat_interleave(
            torch.arange(self.d, device=dev, dtype=torch.int32), counts)
        self.sum_lanes = seg_sum_lanes(coo.chunk_ptr.cpu())
        self.coo_ptrs = tuple(_ptr(t) for t in (coo.row, coo.pos, coo.val))


def _coo_plan(coo: FeatureMajor, dt, dev, n_stream: Optional[int],
              name: str) -> _CooPlan:
    """The launch inputs of a destination-major list of the positive stream,
    checked once per list: its stream positions (against the stream's
    length ``n_stream`` where the pass reads coefficients at them) and
    other ids (against the table's rows) by one read of their extremes,
    its weights (``val``) at storage dtype ``dt`` where it has them."""
    if coo.pos is None:
        raise ValueError(f"{name}: not a list of the positive stream (no "
                         "stream positions)")
    key = (id(coo), "coo", dt, dev, n_stream)
    hit = _xt_checked.get(key)
    if hit is not None and hit.xt is coo:
        return _hold(hit)
    nnz = coo.row.numel()
    _check("coo.pos", coo.pos, torch.int32, (nnz,), dev)
    if coo.val is not None:
        _check("coo.val", coo.val, dt, (nnz,), dev)
    if nnz:
        ids = torch.stack([coo.pos.max(), coo.row.max(), coo.pos.min(),
                           coo.row.min()]).tolist()
        if min(ids[2:]) < 0 or ids[1] >= coo.n_rows or (
                n_stream is not None and ids[0] >= n_stream):
            raise ValueError(f"{name}: the list's stream positions or other "
                             f"ids are outside [0, {n_stream}) / "
                             f"[0, {coo.n_rows})")
    plan = (coo.combine, coo.chunk_dst, coo.slot_feat)
    if any(a is None for a in plan):
        plan = tuple(torch.from_numpy(a).to(dev) for a in
                     xt_plan(coo.feat_ptr.cpu().numpy()))
    return _hold(_plan_of(key, coo, coo.val, plan, dev, _CooPlan))


def _storage(x: float, dt) -> float:
    """x rounded to storage dtype on the host (``sparse_ops.storage_scale``'s
    scalar): exact as the kernel's float argument."""
    return torch.tensor(x, dtype=dt).item()


def _coo_launch(source: int, coo: FeatureMajor, dt, dev, k: int, name: str,
                c=None, B=None, phi=None, scale: float = 1.0,
                lanes: Optional[int] = None):
    """One launch of coo_list_kernel; returns (out0, out1) at storage dtype,
    each (rows, k) or None where the source writes none.  ``lanes``: the
    width-1 sums' lanes a chunk, by default the list's own."""
    if source in (_PAIR, _SQ, _HV) and coo.val is None:
        raise ValueError(f"{name}: the list carries no weights (val: the "
                         "stream's w in list order)")
    p = _coo_plan(coo, dt, dev, None if c is None else c.numel(), name)
    lib = load()
    row, pos, w = p.coo_ptrs
    _, _, chunk_ptr, chunk_dst, feat_ptr, combine, slot_feat, tickets = \
        p.ptrs
    out0 = (None if source == _SQ
            else torch.empty((p.d, k), dtype=dt, device=dev))
    out1 = (torch.empty((p.d, k), dtype=dt, device=dev)
            if source in (_PAIR, _SQ) else None)
    err = lib.ocffm_coo_list(
        _DTYPE_CODE[dt], source, row, pos, w, _ptr(c), _ptr(B), _ptr(phi),
        _storage(scale, dt), chunk_ptr, chunk_dst, p.chunk_row.data_ptr(),
        p.n_chunks, feat_ptr, combine, p.n_combine, slot_feat, tickets,
        p.partial((2 if source == _PAIR else 1) * k).data_ptr(), _ptr(out0),
        _ptr(out1), k, p.sum_lanes if lanes is None else lanes, _stream(dev))
    _raise_on(err, name)
    return out0, out1


def _coo_table(B: torch.Tensor, coo: FeatureMajor, name: str):
    """Checks the gathered table (n_rows, k); returns k."""
    _, k = _table_dtype("B", B)
    if B.shape[0] != coo.n_rows:
        raise ValueError(f"{name}: the list gathers from {coo.n_rows} rows, "
                         f"B has {B.shape[0]}")
    return k


def _coefs(c: torch.Tensor, dt, dev) -> None:
    """Checks the (stream,) coefficients."""
    if c.device != dev:
        raise ValueError(f"c is on {c.device}, expected {dev}")
    if c.dtype != dt:
        raise TypeError(f"c has dtype {c.dtype}, expected {dt}")
    if c.dim() != 1 or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous (nnz,) vector, got "
                         f"{tuple(c.shape)}")


def pos_scatter(c, B, coo: FeatureMajor) -> torch.Tensor:
    """(rows, k) storage: per row of the list, the sum at f32 of
    storage(c[pos] * B[row]) over its entries, rounded once."""
    k = _coo_table(B, coo, "pos_scatter")
    _coefs(c, B.dtype, B.device)
    out, _ = _coo_launch(_COEF, coo, B.dtype, B.device, k, "pos_scatter",
                         c=c, B=B)
    _launches["pos_scatter"] += 1
    return out


def pos_scatter_pair(c, B, coo: FeatureMajor, wq_scale: float = 1.0):
    """(zpos, posq): ``pos_scatter`` of c, and the Jacobi diagonal's
    positive term, the sums of storage(storage(wq * B[row]) * B[row]) with
    wq = storage(w * storage(wq_scale)) from the list's weights, both from
    one read of each row.  With ``c`` None the second alone, (None, posq):
    the pair's squared-only form."""
    k = _coo_table(B, coo, "pos_scatter_pair")
    if c is None:
        _, posq = _coo_launch(_SQ, coo, B.dtype, B.device, k,
                              "pos_scatter_pair", B=B, scale=wq_scale)
        _launches["pos_scatter_pair"] += 1
        return None, posq
    _coefs(c, B.dtype, B.device)
    out = _coo_launch(_PAIR, coo, B.dtype, B.device, k, "pos_scatter_pair",
                      c=c, B=B, scale=wq_scale)
    _launches["pos_scatter_pair"] += 1
    return out


def pos_seg_sum(c, coo: FeatureMajor,
                lanes: Optional[int] = None) -> torch.Tensor:
    """(rows,) storage: per row of the list, the sum at f32 of c[pos] over
    its entries in the order of ``lanes`` (1 or 8) lanes a chunk, by default
    the list's own (``sparse_ops.pos_seg_sum_plain``), rounded once."""
    if c.device.type != "cuda":
        raise ValueError(f"c must be a CUDA tensor, got {c.device}")
    if c.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {c.dtype}")
    _coefs(c, c.dtype, c.device)
    out, _ = _coo_launch(_SUM, coo, c.dtype, c.device, 1, "pos_seg_sum",
                         c=c, lanes=lanes)
    _launches["pos_seg_sum"] += 1
    return out[:, 0]


def pos_hv_coo(phi, B, coo: FeatureMajor, w_scale: float = 1.0):
    """(rows, k) storage: the cross Hv's positive term of a COO side in one
    pass, per row s of the list the sum at f32 of storage(cv * B[row]) with
    cv = storage(storage(storage(dot(phi[s], B[row])) * w) * storage(
    w_scale)), w the list's weights; the dot in ``pos_dot``'s order."""
    k = _coo_table(B, coo, "pos_hv_coo")
    d = coo.feat_ptr.numel() - 1
    _check("phi", phi, B.dtype, (d, k), B.device)
    out, _ = _coo_launch(_HV, coo, B.dtype, B.device, k, "pos_hv_coo", B=B,
                         phi=phi, scale=w_scale)
    _launches["pos_hv_coo"] += 1
    return out


def pos_dot(A, u_ids, B, v_ids) -> torch.Tensor:
    """(n,) storage: out[t] = dot(A[u_ids[t]], B[v_ids[t]]) in _lane_dot's
    order, products at storage, ids (int32) clamped into range."""
    _, k = _table_dtype("A", A)
    dev, dt = A.device, A.dtype
    _check("B", B, dt, (B.shape[0], k), dev)
    n = u_ids.numel()
    _check("u_ids", u_ids, torch.int32, (n,), dev)
    _check("v_ids", v_ids, torch.int32, (n,), dev)
    if A.shape[0] == 0 or B.shape[0] == 0:
        raise ValueError("pos_dot gathers from an empty table")
    out = torch.empty((n,), dtype=dt, device=dev)
    err = load().ocffm_pos_dot(
        _DTYPE_CODE[dt], A.data_ptr(), u_ids.data_ptr(), A.shape[0],
        B.data_ptr(), v_ids.data_ptr(), B.shape[0], out.data_ptr(), n, k,
        _stream(dev))
    _raise_on(err, "pos_dot")
    _launches["pos_dot"] += 1
    return out


# ---------------------------------------------------------------------------
# the Hv variants of hv_pack_bench (B9, B10)
# ---------------------------------------------------------------------------


def _packed_runs(own_p: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The row runs of a lane-packed stream (``sparse_ops.pack_rows``),
    found on the device from the owners in lane 0 of each 32-lane group
    taken in slot order: the packing keeps slot order, so these are the
    runs of the unpacked stream (``layout.row_runs``)."""
    nb, m4, lanes = own_p.shape
    own = own_p[:, :, ::lanes // 4].transpose(1, 2).reshape(nb, 4 * m4)
    return _runs(own, block_rows)


def pos_hv_packed(phi, rows_p, own_p, w_p, dense_mat, num_out: int,
                  block_rows: int, w_scale: float = 1.0,
                  runs=None) -> torch.Tensor:
    """B9: B1's function from the lane-packed stream (n_blocks, MAXC/4,
    128) of ``sparse_ops.pack_rows``, k = 32.  The kernel reads each row's
    run from ``runs`` (the unpacked stream's ``layout.row_runs``; found on
    the device from ``own_p`` without it), not ``own_p``, and copies the
    rows and weights with tensor maps, which need 16-byte-aligned bases:
    ``rows_p``, ``w_p``, ``phi`` and ``dense_mat`` must be."""
    if rows_p.device.type != "cuda":
        raise ValueError(f"rows_p must be a CUDA tensor, got {rows_p.device}")
    if rows_p.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got "
                        f"{rows_p.dtype}")
    if rows_p.dim() != 3 or rows_p.shape[2] != 128 or 0 in rows_p.shape:
        raise ValueError(f"rows_p must be (n_blocks, MAXC/4, 128), got "
                         f"{tuple(rows_p.shape)}")
    if not 0 < block_rows < (1 << 31):
        raise ValueError(f"block_rows={block_rows}")
    dev, dt = rows_p.device, rows_p.dtype
    nb, m4, _ = rows_p.shape
    lib = load()
    for name, t, t_dt in (("rows_p", rows_p, dt), ("w_p", w_p, dt),
                          ("own_p", own_p, torch.int32)):
        _check(name, t, t_dt, (nb, m4, 128), dev)
    out = _hv_out(phi, dense_mat, num_out, nb, 32, block_rows, dev, dt)
    for name, t in (("rows_p", rows_p), ("w_p", w_p), ("phi", phi),
                    ("dense_mat", dense_mat)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (tensor-map "
                             "copies and vector loads)")
    if runs is None:
        runs = _packed_runs(own_p, block_rows)
    _check("runs", runs, torch.int32, (nb, block_rows + 1), dev)
    err = lib.ocffm_pos_hv_packed(
        _DTYPE_CODE[dt], phi.data_ptr(), rows_p.data_ptr(), runs.data_ptr(),
        w_p.data_ptr(), dense_mat.data_ptr(), out.data_ptr(), nb, m4,
        block_rows, float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_packed")
    _launches["pos_hv_packed"] += 1
    return out


def pos_hv_blocked_g(phi, rows, own, w_blk, dense_mat, num_out: int,
                     block_rows: int, groups: int, w_scale: float = 1.0,
                     runs=None) -> torch.Tensor:
    """B10: B1 with ``groups`` row blocks per CTA (n_blocks % G == 0), their
    spans one ring of stages; reads each row's run from ``runs`` (see
    ``_row_runs``)."""
    lib, nb, maxc, k = _stream_rows(rows, own, block_rows)
    if groups < 1 or nb % groups:
        raise ValueError(f"G={groups} must divide n_blocks={nb}")
    dev, dt = rows.device, rows.dtype
    _check("w_blk", w_blk, dt, (nb, maxc), dev)
    out = _hv_out(phi, dense_mat, num_out, nb, k, block_rows, dev, dt)
    runs = _row_runs(runs, own, block_rows)
    err = lib.ocffm_pos_hv_blocked_g(
        _DTYPE_CODE[dt], phi.data_ptr(), rows.data_ptr(), runs.data_ptr(),
        w_blk.data_ptr(), dense_mat.data_ptr(), out.data_ptr(), nb, maxc, k,
        block_rows, groups, float(w_scale), _stream(dev))
    _raise_on(err, "pos_hv_blocked_g")
    _launches["pos_hv_blocked_g"] += 1
    return out


# ---------------------------------------------------------------------------
# the CG recurrence of a Newton solve (cg_ops.cu): its start, and one
# iteration after the Hv with the stop test on the card
# ---------------------------------------------------------------------------

CG_WORDS = 16  # 4-byte words of a solve's scalar block (cg_ops.cu CgScalars)
_CG_F32 = ("g2", "r2", "rz", "alpha", "beta", "thr")  # words 0-5
_CG_INT = ("it", "done", "active", "ok")  # words 6-9
_IT, _DONE = 6, 7
# The recurrence's sums take the order of torch's CUDA sum of a contiguous
# float32 tensor (ATen/native/cuda/Reduce.cuh, one output), so that the
# loop on the card gives the bits of the eager torch loop it replaced.
# That order depends on the card's multiprocessors and threads per
# multiprocessor; on the CPU it is the H100's.
CG_MAX_THREADS = 512  # Reduce.cuh's threads per CTA at most
CG_VEC = 4  # elements per vectorized load
H100_SMS, H100_SM_THREADS = 132, 2048
# The step kernel (cg_iter_kernel) runs the three stages of an iteration in
# one launch, split by grid-wide barriers, so its whole grid must be
# resident: built for two CTAs of 512 threads an SM (__launch_bounds__(512,
# 2): at most 64 registers a thread), each with at most half the SM's 228
# KB of shared memory, less the KB the card keeps for each CTA and a KB of
# margin (CG_SMEM_RESERVE); a lone CTA may take a CTA's most, less that.
CG_STEP_REGS = 64
H100_SM_REGS = 65536
H100_SM_SMEM = 233472  # bytes of shared memory an SM gives its CTAs
H100_CTA_SMEM = 232448  # a CTA's most (227 KB)
CG_SMEM_RESERVE = 2048  # bytes: the card's KB a CTA and a KB of margin
_sm_shape: Dict[Any, tuple] = {}


@dataclass(frozen=True)
class CgConfig:
    """The launch of one sum over n elements: ``vec``: 4 elements a load
    (n >= 128), ``threads`` per CTA (one row of them), ``ctas`` CTAs (more
    than one: the CTAs' partials are added in a last CTA's order)."""

    vec: bool
    threads: int
    ctas: int


def _sm(device) -> tuple:
    """(multiprocessors, threads per multiprocessor) of the card the sum
    runs on, the H100's off the card."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMS, H100_SM_THREADS
    dev = torch.device(device)
    hit = _sm_shape.get(dev)
    if hit is None:
        prop = torch.cuda.get_device_properties(dev)
        hit = _sm_shape[dev] = (prop.multi_processor_count,
                                prop.max_threads_per_multi_processor)
    return hit


def cg_config(n: int, device=None) -> CgConfig:
    """Reduce.cuh's setReduceConfig for the sum of n contiguous float32
    elements into one output: 4 elements a load from n = 128, the CTA as
    wide as the loads (a power of two, at most 512), split over CTAs when
    each thread would add 256 or more."""
    def last_pow2(x: int) -> int:
        return 1 << (max(int(x), 1).bit_length() - 1)

    vec = n >= 128
    dim0 = n // CG_VEC if vec else n
    threads = (last_pow2(dim0) if dim0 < CG_MAX_THREADS
               else CG_MAX_THREADS)
    per_thread = -(-n // threads)
    ctas = 1
    if per_thread >= 256:
        sms, sm_threads = _sm(device)
        target = sms * (sm_threads // threads)
        ctas = max(min(target, -(-per_thread // 16)),
                   -(-per_thread // 256))
    return CgConfig(vec, threads, ctas)


@dataclass(frozen=True)
class CgPlan:
    """The step kernel's hardware launch for torch's virtual one (``cfg``):
    ``grid`` CTAs of ``cfg.threads``, each carrying ``per`` virtual CTAs
    (virtual CTA j * grid + b in hardware CTA b, j < per), one halving tree
    each; ``cache`` loads of 4 per virtual thread whose V stays in shared
    memory from stage 1 to 3 (of ``loads``, the most a virtual thread
    makes); ``smem`` bytes of dynamic shared memory a CTA (V's cache, then
    two values per virtual thread); ``per_sm`` CTAs an SM holds by threads
    and registers."""

    cfg: CgConfig
    per: int
    grid: int
    loads: int
    cache: int
    smem: int
    per_sm: int


def cg_plan(n: int, device=None) -> CgPlan:
    """The hardware launch of one iteration over n elements: torch's
    virtual CTAs (``cg_config``) dealt over as few resident CTAs as hold
    them (one where there is one virtual CTA), and as many of each virtual
    thread's loads of V kept in shared memory as the CTA's share of it
    allows.  The order of every sum is the virtual launch's whatever the
    plan."""
    key = (n, device)
    hit = _cg_plans.get(key)
    if hit is not None:
        return hit
    cfg = cg_config(n, device)
    sms, sm_threads = _sm(device)
    nt = cfg.threads
    per_sm = max(1, min(sm_threads // nt,
                        H100_SM_REGS // (nt * CG_STEP_REGS)))
    if cfg.ctas == 1:
        per, grid = 1, 1
        budget = H100_CTA_SMEM - CG_SMEM_RESERVE
    else:
        per = -(-cfg.ctas // (sms * per_sm))
        grid = -(-cfg.ctas // per)
        budget = min(H100_CTA_SMEM, H100_SM_SMEM // per_sm) - CG_SMEM_RESERVE
    vals = 2 * per * nt * 4
    span = cfg.ctas * nt
    loads = -(-(n // CG_VEC) // span) if cfg.vec else 0
    cache = min(loads, max(0, budget - vals) // (per * nt * 16))
    plan = CgPlan(cfg, per, grid, loads, cache, vals + per * cache * nt * 16,
                  per_sm)
    _cg_plans[key] = plan
    return plan


_cg_plans: Dict[Any, CgPlan] = {}
_cg_blocks: Dict[Any, int] = {}


def cg_blocks(step: bool, threads: int, smem: int, storage, jacobi: bool,
              device) -> int:
    """The CTAs an SM of the step kernel (else cg_init_kernel) at
    ``threads`` threads and ``smem`` bytes of dynamic shared memory on the
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after raising the
    kernel's shared memory cap to ``smem``)."""
    dev = torch.device(device)
    key = (dev, bool(step), storage, bool(jacobi), threads, smem)
    hit = _cg_blocks.get(key)
    if hit is None:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = load().ocffm_cg_blocks(
                int(bool(step)), _DTYPE_CODE[storage], int(bool(jacobi)),
                threads, smem, ctypes.byref(blocks))
        _raise_on(err, "cg occupancy")
        hit = _cg_blocks[key] = blocks.value
    return hit


def cg_step_blocks(plan: CgPlan, storage, jacobi: bool, device) -> int:
    """The step kernel's CTAs an SM at the plan's width and shared memory
    (``cg_blocks``); raises where the plan's grid would not be resident,
    which its barriers need.  Called where a state is made, outside any
    stream capture."""
    dev = torch.device(device)
    hit = cg_blocks(True, plan.cfg.threads, plan.smem, storage, jacobi, dev)
    sms = _sm(dev)[0]
    if hit < 1 or plan.grid > hit * sms:
        raise RuntimeError(
            f"cg_step: a grid of {plan.grid} CTAs of {plan.cfg.threads} "
            f"threads with {plan.smem} B of shared memory is not resident "
            f"({hit} CTAs an SM on {sms} SMs)")
    return hit


@dataclass
class CgState:
    """One Newton solve's CG recurrence: S, R, V at the float32 floor
    (float64 at float64, which runs only on the CPU), V at storage dtype for
    the Hv (``Vs``: V itself where storage is the floor), Jacobi's D at the
    floor or None, and the scalars.  On the card ``sc`` is the solve's
    scalar block (CG_WORDS int32 words, cg_ops.cu CgScalars) and ``part``
    the CTAs' partial sums; in the plain version ``sc`` is a dict of 0-dim
    tensors (g2, r2, rz, thr) and ints (it, done) and ``part`` None."""

    S: torch.Tensor
    R: torch.Tensor
    V: torch.Tensor
    Vs: torch.Tensor
    D: Optional[torch.Tensor]
    sc: Any
    part: Optional[torch.Tensor]
    max_iter: int


def cg_state(shape, storage, jacobi: bool, max_iter: int,
             device: torch.device) -> CgState:
    """A state's buffers for vectors of ``shape`` (a CUDA graph's, which
    ``cg_init(out=)`` starts each solve in); on the card the step kernel's
    residency at this shape is checked here (``cg_step_blocks``)."""
    n = math.prod(shape)
    if torch.device(device).type == "cuda":
        cg_step_blocks(cg_plan(n, torch.device(device)), storage, jacobi,
                       device)
    V = torch.empty(shape, dtype=torch.float32, device=device)
    return CgState(
        S=torch.empty_like(V), R=torch.empty_like(V), V=V,
        Vs=V if storage == torch.float32 else torch.empty(
            shape, dtype=storage, device=device),
        D=torch.empty_like(V) if jacobi else None,
        sc=torch.zeros(CG_WORDS, dtype=torch.int32, device=device),
        part=torch.empty(3 * cg_config(n, device).ctas, dtype=torch.float32,
                         device=device),
        max_iter=max_iter)


def cg_init(G: torch.Tensor, D: Optional[torch.Tensor], storage,
            eps: float, max_iter: int,
            out: Optional[CgState] = None) -> CgState:
    """The solve's start (cg_init_kernel): S = 0, R = -G, V = -G (Jacobi:
    -G / D) and V at storage, g2, rz, the threshold eps g2, the count and
    the done flag.  ``out``: a state whose buffers to start in (D copied
    into its own), else new ones."""
    if G.device.type != "cuda":
        raise ValueError(f"G must be a CUDA tensor, got {G.device}")
    if G.dtype not in _DTYPE_CODE or storage not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {G.dtype} "
                        f"and storage {storage}")
    if G.dim() != 2 or G.numel() == 0:
        raise ValueError(f"G must be a non-empty (rows, k) table, got "
                         f"{tuple(G.shape)}")
    lib, dev = load(), G.device
    Gc = G.to(torch.float32).contiguous()
    if out is None:
        out = cg_state(tuple(G.shape), storage, D is not None, max_iter, dev)
    if (D is None) != (out.D is None) or out.max_iter != max_iter:
        raise ValueError("the state's Jacobi D or cap is not this solve's")
    _cg_check(out, tuple(G.shape), storage, dev)
    if D is not None:
        if tuple(D.shape) != tuple(G.shape):
            raise ValueError(f"D has shape {tuple(D.shape)}, G "
                             f"{tuple(G.shape)}")
        out.D.copy_(D)
    n = G.numel()
    cfg = cg_config(n, dev)
    err = lib.ocffm_cg_init(
        _DTYPE_CODE[storage], Gc.data_ptr(), _ptr(out.D), out.S.data_ptr(),
        out.R.data_ptr(), out.V.data_ptr(), out.Vs.data_ptr(),
        out.part.data_ptr(), out.sc.data_ptr(), n, cfg.ctas, cfg.threads,
        int(cfg.vec), float(eps), int(max_iter), _stream(dev))
    _raise_on(err, "cg_init")
    _launches["cg_init"] += 1
    return out


def _cg_check(st: CgState, shape, storage, dev) -> None:
    n = math.prod(shape)
    for name in ("S", "R", "V", "D"):
        t = getattr(st, name)
        if t is not None:
            _check(name, t, torch.float32, shape, dev)
    _check("Vs", st.Vs, storage, shape, dev)
    if storage == torch.float32 and st.Vs.data_ptr() != st.V.data_ptr():
        raise ValueError("at float32 storage Vs is V itself")
    _check("sc", st.sc, torch.int32, (CG_WORDS,), dev)
    _check("part", st.part, torch.float32, (3 * cg_config(n, dev).ctas,),
           dev)


def cg_step(st: CgState, Hv: torch.Tensor) -> None:
    """One iteration after the Hv, one launch of cg_iter_kernel (on the
    plan's grid, ``cg_plan``), in place on the state's buffers; a solve
    already stopped keeps every bit."""
    dev, storage = st.S.device, st.Vs.dtype
    shape = tuple(st.S.shape)
    _check("Hv", Hv, storage, shape, dev)
    _cg_check(st, shape, storage, dev)
    n = st.S.numel()
    plan = cg_plan(n, dev)
    cfg = plan.cfg
    err = load().ocffm_cg_step(
        _DTYPE_CODE[storage], Hv.data_ptr(), _ptr(st.D), st.S.data_ptr(),
        st.R.data_ptr(), st.V.data_ptr(), st.Vs.data_ptr(),
        st.part.data_ptr(), st.sc.data_ptr(), n, cfg.ctas, cfg.threads,
        int(cfg.vec), plan.per, plan.grid, plan.cache, plan.smem,
        st.max_iter, _stream(dev))
    _raise_on(err, "cg_step")
    _launches["cg_step"] += 1


_read_host: Dict[Any, tuple] = {}


def cg_read(st: CgState):
    """(done, it): the stop flag and the count, copied through pinned
    memory and waited for (the host's one read of a group of
    iterations)."""
    dev = st.sc.device
    host, ev = _read_host.get(dev, (None, None))
    if host is None:
        host = torch.empty(2, dtype=torch.int32, pin_memory=True)
        ev = torch.cuda.Event()
        _read_host[dev] = (host, ev)
    host.copy_(st.sc[_IT:_DONE + 1], non_blocking=True)
    ev.record(torch.cuda.current_stream(dev))
    ev.synchronize()
    it, done = host.tolist()
    return bool(done), it


def cg_scalars(st: CgState) -> Dict[str, Any]:
    """Every scalar of the state's block (a synchronous copy): floats and
    ints by name."""
    words = st.sc.cpu()
    f = words[:len(_CG_F32)].view(torch.float32).tolist()
    i = words[len(_CG_F32):len(_CG_F32) + len(_CG_INT)].tolist()
    return {**dict(zip(_CG_F32, f)), **dict(zip(_CG_INT, i))}


# ---------------------------------------------------------------------------
# each row's top K (topk_ops.cu): predict's ranking, the evaluator's top-K
# ---------------------------------------------------------------------------

TOPK_MAX_K = 256  # the largest K the kernel takes (its buckets 16 .. 256)
_topk_segs: Dict[Any, int] = {}
_topk_tickets: Dict[Any, torch.Tensor] = {}


def topk_segs(rows: int, n: int, k: int,
              dtype: torch.dtype = torch.float32) -> int:
    """The segments a row of the launch for (rows, n, k) at ``dtype``: a
    row is split only where the rows alone leave SMs idle (csrc/
    topk_ops.cu ``kCtasPerSmK16``), each warp at least four rounds of
    loads."""
    key = (rows, n, k, dtype)
    hit = _topk_segs.get(key)
    if hit is None:
        hit = _topk_segs[key] = load().ocffm_topk_segs(_DTYPE_CODE[dtype],
                                                       rows, n, k)
    return hit


def _tickets(rows: int, dev, stream: int) -> torch.Tensor:
    """A row's ticket each, zero between launches (the last CTA of a row
    resets its own); shared by the launches on one stream, which run in
    order."""
    key = (dev, stream)
    t = _topk_tickets.get(key)
    if t is None or t.numel() < rows:
        t = _topk_tickets[key] = torch.zeros(max(rows, 1024),
                                             dtype=torch.int32, device=dev)
    return t


def topk_rows(z: torch.Tensor, k: int):
    """(values (rows, min(k, n)) at z's dtype, ids int64) of each row of the
    float32 or bfloat16 (rows, n) ``z``: the first columns of
    ``torch.sort(z, dim=1, descending=True, stable=True)``, bit for bit.
    The rows may be a column slice of a wider matrix (unit column stride,
    any row stride of at least n)."""
    if z.dtype not in _DTYPE_CODE:
        raise TypeError(f"topk_rows takes float32 or bfloat16, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"z must be (rows, n), got {tuple(z.shape)}")
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"k={k} outside the kernel's range (1..{TOPK_MAX_K})")
    rows, n = z.shape
    if z.stride(1) != 1 or (rows > 1 and z.stride(0) < n):
        raise ValueError(f"z's rows must be unit-stride and apart, got "
                         f"strides {z.stride()}")
    if n >= 1 << 31:
        raise ValueError(f"rows of {n} elements: columns past 2**31")
    if z.device.type != "cuda":
        raise ValueError(f"z must be a CUDA tensor, got {z.device}")
    k = min(k, n)
    dev = z.device
    vals = torch.empty((rows, k), dtype=z.dtype, device=dev)
    ids = torch.empty((rows, k), dtype=torch.int64, device=dev)
    if rows == 0 or k == 0:
        return vals, ids
    lib = load()
    segs = topk_segs(rows, n, k, z.dtype)
    if rows * segs >= 1 << 31:
        raise ValueError(f"{rows} rows x {segs} segments: grid too large")
    part = (torch.empty(rows * segs * k, dtype=torch.int64, device=dev)
            if segs > 1 else None)
    stream = _stream(dev)
    err = lib.ocffm_topk_rows(
        _DTYPE_CODE[z.dtype], z.data_ptr(), z.stride(0), rows, n, k, segs,
        vals.data_ptr(), ids.data_ptr(), _ptr(part),
        _tickets(rows, dev, stream).data_ptr(), stream)
    _raise_on(err, "topk_rows")
    _launches["topk_rows"] += 1
    return vals, ids
