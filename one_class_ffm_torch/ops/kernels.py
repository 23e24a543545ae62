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
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from .layout import FeatureMajor, xt_plan

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "blocked_ops.cu", "table_ops.cu", "project_ops.cu", "hv_variants.cu"))
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
# B10), and the plain COO positive passes of a side without a blocked
# layout (the X^T stage over the side's list of the positive stream: the
# gradient's and Hv's scatter, with the Jacobi payload in a second launch,
# and the self blocks' per-row sums)
KERNELS = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked",
           "pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl",
           "project", "scatter", "pos_scatter_blocked_diag",
           "grad_cross_tbl_diag", "grad_self_tbl_diag", "pos_hv_packed",
           "pos_hv_blocked_g", "pos_scatter", "pos_scatter_pair",
           "pos_seg_sum")
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
        i32, vp, vp, i32, vp, vp, vp, vp, vp, i32, vp, vp, i32, vp, vp, i32,
        vp, vp, vp]
    lib.ocffm_project.argtypes = [i32, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.ocffm_pos_hv_packed.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i64, i32, i32, f32, vp]
    lib.ocffm_pos_hv_blocked_g.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, f32, vp]
    for fn in (lib.ocffm_pos_hv_tbl_rows, lib.ocffm_grad_cross_tbl_rows,
               lib.ocffm_hv_self_tbl_rows, lib.ocffm_grad_self_tbl_rows,
               lib.ocffm_xt_scatter, lib.ocffm_project,
               lib.ocffm_pos_hv_packed, lib.ocffm_pos_hv_blocked_g):
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
    """A feature-major list as one launch of the X^T kernel reads it: the
    device pointers of its arrays and plan (its values, or for a list of
    the positive stream its stream positions, the other NULL), its sizes,
    and the launch's scratch: tickets (one int per feature, zero between
    launches) and partial rows per width k.  The scratch is shared by the
    list's launches, which run in order on the one stream of a solve."""

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
            xt.row, vals, xt.pos, xt.chunk_ptr, chunk_dst, xt.feat_ptr,
            combine, slot_feat, self.tickets))
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


def _xt_inputs(xt: FeatureMajor, dt, dev, squared: bool,
               name: str) -> _XtPlan:
    """The launch inputs of a feature-major list, checked once per list;
    the plan is derived from ``feat_ptr`` (``layout.xt_plan``) for a list
    built without it."""
    key = (id(xt), dt, dev, squared)
    hit = _xt_checked.get(key)
    if hit is not None and hit.xt is xt:
        return hit
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
    return _plan_of(key, xt, vals, plan, dev)


def _plan_of(key, xt: FeatureMajor, vals, plan, dev) -> _XtPlan:
    """Checks a list's index arrays and plan; caches and returns its
    launch inputs."""
    nnz, n_chunks, d = xt.row.numel(), xt.chunk_ptr.numel() - 1, \
        xt.feat_ptr.numel() - 1
    combine, chunk_dst, slot_feat = plan
    _check("xt.row", xt.row, torch.int32, (nnz,), dev)
    _check("xt.chunk_ptr", xt.chunk_ptr, torch.int32, (n_chunks + 1,), dev)
    _check("xt.feat_ptr", xt.feat_ptr, torch.int32, (d + 1,), dev)
    _check("xt.chunk_dst", chunk_dst, torch.int32, (n_chunks,), dev)
    _check("xt.combine", combine, torch.int32, (combine.numel(),), dev)
    out = _XtPlan(xt, vals, plan, dev)
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
    row, vals, pos, chunk_ptr, chunk_dst, feat_ptr, combine, slot_feat, \
        tickets = p.ptrs
    out = torch.empty((p.d, k), dtype=torch.float32, device=dev)
    err = lib.ocffm_xt_scatter(
        _DTYPE_CODE[dt], _ptr(payload), _ptr(scale), source, row, vals, pos,
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
# the plain COO positive passes: the X^T stage over a side's list of the
# positive stream, a coefficient per stream entry
# ---------------------------------------------------------------------------

# the kernel's sources of an entry's term (table_ops.cu XtSource)
_COEF, _COEF_SQ, _COEF_SUM = 3, 4, 5


def _coo_inputs(coo: FeatureMajor, c: torch.Tensor, name: str) -> _XtPlan:
    """The launch inputs of a destination-major list of the positive stream
    (``layout.coo_list``), checked once per list (its stream positions and
    other ids against the coefficients' and the table's lengths: one read
    of their largest values, then cached); ``c`` the coefficients (nnz,)."""
    if c.device.type != "cuda":
        raise ValueError(f"c must be a CUDA tensor, got {c.device}")
    if c.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16, got {c.dtype}")
    if c.dim() != 1 or not c.is_contiguous():
        raise ValueError(f"c must be a contiguous (nnz,) vector, got "
                         f"{tuple(c.shape)}")
    if coo.pos is None:
        raise ValueError(f"{name}: not a list of the positive stream (no "
                         "stream positions)")
    dev = c.device
    key = (id(coo), "coo", dev, c.numel())
    hit = _xt_checked.get(key)
    if hit is not None and hit.xt is coo:
        return hit
    plan = (coo.combine, coo.chunk_dst, coo.slot_feat)
    if any(a is None for a in plan):
        plan = tuple(torch.from_numpy(a).to(dev) for a in
                     xt_plan(coo.feat_ptr.cpu().numpy()))
    _check("coo.pos", coo.pos, torch.int32, (coo.row.numel(),), dev)
    if coo.row.numel():
        hi = torch.stack([coo.pos.max(), coo.row.max()]).tolist()
        lo = torch.stack([coo.pos.min(), coo.row.min()]).tolist()
        if min(lo) < 0 or hi[0] >= c.numel() or hi[1] >= coo.n_rows:
            raise ValueError(f"{name}: the list's stream positions or other "
                             f"ids are outside [0, {c.numel()}) / "
                             f"[0, {coo.n_rows})")
    return _plan_of(key, coo, None, plan, dev)


def _coo_table(B: torch.Tensor, coo: FeatureMajor, c: torch.Tensor,
               name: str):
    """Checks the gathered table (n_rows, k) and the coefficients' dtype;
    returns (lib, k)."""
    lib, k = _table_dtype("B", B)
    if B.shape[0] != coo.n_rows:
        raise ValueError(f"{name}: the list gathers from {coo.n_rows} rows, "
                         f"B has {B.shape[0]}")
    _check("c", c, B.dtype, (c.numel(),), B.device)
    return lib, k


def pos_scatter(c, B, coo: FeatureMajor) -> torch.Tensor:
    """(rows, k) storage: per row of the list, the sum at f32 of
    storage(c[pos] * B[row]) over its entries, cast once (the X^T stage's
    coefficient source)."""
    lib, k = _coo_table(B, coo, c, "pos_scatter")
    p = _coo_inputs(coo, c, "pos_scatter")
    out = _xt_launch(lib, p, B, c, _COEF, k, B.dtype, B.device,
                     "pos_scatter")
    _launches["pos_scatter"] += 1
    return out.to(B.dtype)


def pos_scatter_pair(c, wq, B, coo: FeatureMajor):
    """(zpos, posq): ``pos_scatter`` of c, and the Jacobi diagonal's
    positive term, the sums of storage(storage(wq[pos] * B[row]) * B[row]),
    in a second launch over the same list."""
    lib, k = _coo_table(B, coo, c, "pos_scatter_pair")
    _check("wq", wq, B.dtype, (c.numel(),), B.device)
    p = _coo_inputs(coo, c, "pos_scatter_pair")
    outs = [_xt_launch(lib, p, B, coef, src, k, B.dtype, B.device,
                       "pos_scatter_pair")
            for coef, src in ((c, _COEF), (wq, _COEF_SQ))]
    _launches["pos_scatter_pair"] += 1
    return tuple(o.to(B.dtype) for o in outs)


def pos_seg_sum(c, coo: FeatureMajor) -> torch.Tensor:
    """(rows,) storage: per row of the list, the sum at f32 of c[pos] over
    its entries, cast once (the coefficient source at width 1, a lane per
    chunk)."""
    lib = load()
    p = _coo_inputs(coo, c, "pos_seg_sum")
    out = _xt_launch(lib, p, None, c, _COEF_SUM, 1, c.dtype, c.device,
                     "pos_seg_sum")[:, 0]
    _launches["pos_seg_sum"] += 1
    return out.to(c.dtype)


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
