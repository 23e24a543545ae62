#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check every part of it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a, one
   compiler per source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card, on
   the arguments its first call receives in a real half-solve, at float32
   and bfloat16: bit-identical on repeat, max-rel within the bound (1e-5 /
   5e-3; the plain versions add in the kernels' order, so they agree bit
   for bit), with kernel, plain and library times (CUDA events, float32)
   and the bound of the work (bytes over 3.35 TB/s or operations over 67
   TFLOP/s f32, whichever is larger, counted from the inputs): the three
   blocked kernels in MF solves (200k users x 20k items, k=32, both solve
   sides); the four fused table kernels and the projection B8 in FFM solves
   (the same rows, u-side field D=1000 and v-side field D=500); the blocked
   kernels, B8 and the general scatter in FM solves (one flattened field
   per side, D=201,000 and 20,500);
4. reference: on a small MF problem, a small FFM problem with self blocks
   and a small FM problem whose fields are above a lowered fused-table cap,
   the gradients and Hv products the kernels give on the card match the
   fp64 numpy oracle, and the objective the solver tracks through two
   kernel-driven epochs matches the oracle's brute-force loss;
5. main path, MF: the port's Trainer trains MF --ns at 200,000 users x
   20,000 items, ~5 positives per user, k=32, float32 for 3 epochs and
   validates once; its three kernels and B8 must have launched;
6. main path, FFM: the Trainer trains the bench headline FFM (2 user and 2
   item fields, self blocks) at the same sizes; B1-B8 (all but the
   general scatter) must have launched;
7. main path, FM: the Trainer trains FM with self blocks (one field per
   side, 201,000 and 20,500 features, above the fused-table cap) at the
   same sizes; B1-B3, B8 and the general scatter must have launched.  On
   every path the objective must fall every epoch and every metric must be
   finite; one more epoch under torch.profiler gives the device's idle
   share and the kernels that take the time;
8. entry point: ``python -m one_class_ffm_torch`` on small text datasets,
   MF with --ns, FFM without, and FM with its user field above the cap,
   must exit 0.

The line before the last is a JSON object with one entry per kernel: its
launches summed over the three main paths, its largest error against the
plain version, and its times and bound summed over the sides and shapes
of phase 3.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the one_class_ffm_torch package beside this file,
it exits 1 and prints no result.  Nothing here imports jax or the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# per kernel: the TPU kernel it replaces (file:line of the pallas_call
# wrapper of the twin the TPU path ships, in the JAX package; the general
# scatter replaces the XLA op ``scatter``) and its source
_JAX_OPS = "one_class_ffm_tpu/ops/sparse_ops.py"
REPLACES = {
    "pos_hv_blocked": f"{_JAX_OPS}:1507",
    "pos_scatter_blocked": f"{_JAX_OPS}:1623",
    "pos_gap_blocked": f"{_JAX_OPS}:1786",
    "pos_hv_tbl": f"{_JAX_OPS}:1566",
    "grad_cross_tbl": f"{_JAX_OPS}:1695",
    "hv_self_tbl": f"{_JAX_OPS}:1836",
    "grad_self_tbl": f"{_JAX_OPS}:1900",
    "project": f"{_JAX_OPS}:81",
    "scatter": f"{_JAX_OPS}:190",
}
BLOCKED = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked")
TABLE = ("pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl")
WIDE = ("project", "scatter")
_CSRC = "one_class_ffm_torch/csrc/"
SOURCE = {name: _CSRC + ("blocked_ops.cu" if name in BLOCKED
                         else "project_ops.cu" if name == "project"
                         else "table_ops.cu")
          for name in REPLACES}
BOUND = {"float32": 1e-5, "bfloat16": 5e-3}  # max-rel, scripts/kt_debug.py
# the H100 SXM's published peaks (NVIDIA's H100 datasheet): device memory
# and float32 outside the tensor cores, which is what these kernels use
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the bench headline FFM (bench.py): field 0 of each side is the id field,
# field 1 a categorical field of 1000 (users) / 500 (items) features; FM
# flattens both into one field per side
N_USERS, N_ITEMS = 200_000, 20_000
FFM_DIMS = dict(dims_u=(N_USERS, 1000), dims_v=(N_ITEMS, 500))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data: synthetic MF / FFM / FM with a held-out validation split, in memory
# ---------------------------------------------------------------------------


def flatten_fields(pf):
    """One field per side with offset ids: the FM encoding of a side's
    fields (scripts/parity_check.py flatten_fields, on padded arrays).  A
    pad slot keeps val == 0."""
    import numpy as np

    from one_class_ffm_torch.data.dataset import PaddedFields

    offs = np.concatenate([[0], np.cumsum(pf.Ds)[:-1]])
    idx = np.concatenate([pf.idx[f] + offs[f] for f in range(pf.f)],
                         axis=1).astype(np.int32)
    return PaddedFields(m=pf.m, m_true=pf.m_true, f=1,
                        Ds=(int(sum(pf.Ds)),), idx=(idx,),
                        val=(np.concatenate(pf.val, axis=1),),
                        freq=(np.concatenate(pf.freq),), row_nnz=pf.row_nnz)


def build_data(n_users: int, n_items: int, avg_pos: float, seed: int,
               dims_u=None, dims_v=None, self_side: bool = False,
               fm: bool = False, row_multiple: int = 256,
               va_frac: float = 0.2):
    """LoadedData from ``generate_vectorized``: one identity id field per
    side (MF) unless ``dims_u``/``dims_v`` name more fields, flattened into
    one field per side when ``fm``, with a fraction of each user's
    positives held out for validation as ``write_dataset`` does (users keep
    >= 1 training positive; users with no held-out label are not test
    users; test users keep their feature rows)."""
    import numpy as np

    from one_class_ffm_torch.data.dataset import (
        Interactions,
        PaddedFields,
        pad_labels,
    )
    from one_class_ffm_torch.data.synth import SynthSpec, generate_vectorized
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.train import LoadedData

    spec = SynthSpec(n_users=n_users, n_items=n_items,
                     fu=len(dims_u) if dims_u else 1,
                     fv=len(dims_v) if dims_v else 1,
                     dims_u=dims_u, dims_v=dims_v, avg_pos=avg_pos, seed=seed)
    (du, dv), u_pad, v_pad, y_all = generate_vectorized(
        spec, np.float32, row_multiple=row_multiple)
    if fm:
        u_pad, v_pad = flatten_fields(u_pad), flatten_fields(v_pad)
        du, dv = list(u_pad.Ds), list(v_pad.Ds)
    real = y_all.w > 0
    u, v = y_all.u[real].astype(np.int64), y_all.v[real].astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    order = np.lexsort((rng.random(u.size), u))  # by user, shuffled within
    u, v = u[order], v[order]
    cnt = np.bincount(u, minlength=n_users)
    n_va = np.minimum((cnt * va_frac).astype(np.int64),
                      np.maximum(cnt - 1, 0))
    rank = np.arange(u.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    is_va = rank < n_va[u]

    tr = np.lexsort((v[~is_va], u[~is_va]))
    ut, vt = u[~is_va][tr], v[~is_va][tr]
    indptr = np.zeros(n_users + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(ut, minlength=n_users))
    y_pad = pad_labels(Interactions(m=n_users, n=n_items, indptr=indptr,
                                    col=vt),
                       u_pad.m, v_pad.m, nnz_multiple=row_multiple * 8,
                       dtype=np.float32)
    popular = np.bincount(vt, minlength=n_items).astype(np.float64)
    popular /= popular.sum()

    va_users = np.nonzero(n_va > 0)[0]
    uv, vv = u[is_va], v[is_va]
    starts = np.searchsorted(uv, va_users)
    ends = np.searchsorted(uv, va_users, side="right")
    va_labels = [np.sort(vv[s:e]) for s, e in zip(starts, ends)]
    mt = len(va_users)
    mt_pad = -(-mt // row_multiple) * row_multiple
    idxs, vals = [], []
    for fi in range(u_pad.f):
        idx = np.zeros((mt_pad, u_pad.idx[fi].shape[1]), np.int32)
        val = np.zeros((mt_pad, u_pad.idx[fi].shape[1]), np.float32)
        idx[:mt], val[:mt] = u_pad.idx[fi][va_users], u_pad.val[fi][va_users]
        idxs.append(idx)
        vals.append(val)
    row_nnz = np.zeros(mt_pad, np.int32)
    row_nnz[:mt] = u_pad.row_nnz[va_users]
    uva = PaddedFields(m=mt_pad, m_true=mt, f=u_pad.f, Ds=u_pad.Ds,
                       idx=tuple(idxs), val=tuple(vals), freq=u_pad.freq,
                       row_nnz=row_nnz)
    return LoadedData(
        layout=BlockLayout.make(du, dv, self_side), u_pad=u_pad,
        v_pad=v_pad, y_pad=y_pad, popular=popular, uva_pad=uva,
        va_labels=va_labels, n_items_true=n_items, m_users_true=n_users,
        nnz_true=y_pad.nnz_true)


def make_trainer(data, device, k: int = 32, dtype: str = "float32",
                 epochs: int = 3):
    from one_class_ffm_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(item_path="<memory>", train_path="<memory>", k=k,
                      lam=0.05, omega=0.1, r=-1.0, nr_pass=epochs,
                      self_side=data.layout.self_side, dtype=dtype,
                      eval_every=epochs, seed=0)
    return Trainer(cfg, data=data, device=device)


@contextlib.contextmanager
def fused_cap(cap: int):
    """Lower the fused-table cap while problems are built, so that small
    fields take the wide-field path."""
    from one_class_ffm_torch.solver import torch_solver

    saved = torch_solver.FUSED_TBL_D
    torch_solver.FUSED_TBL_D = cap
    try:
        yield
    finally:
        torch_solver.FUSED_TBL_D = saved


def train_and_validate(trainer, epochs: int):
    """The main path through ``Trainer.run``, one epoch per call (``run``
    continues from ``epoch_idx`` up to ``cfg.nr_pass``, as a resumed run
    does), reading the objective between epochs; the trainer validates at
    its ``eval_every`` epoch.  Returns per-epoch seconds, CG iteration
    counts and objectives, the metrics, the log row and the validation
    seconds."""
    import dataclasses

    state = trainer.init_state()
    objectives = [float(trainer.solver.objective(state))]
    rows, metrics = [], {}
    for ep in range(1, epochs + 1):
        trainer.cfg = dataclasses.replace(trainer.cfg, nr_pass=ep)
        metrics = trainer.run(log=rows.append) or metrics
        objectives.append(float(trainer.solver.objective(trainer.state)))
    hist = trainer.history[-epochs:]
    rows = [r for r in rows if not r.startswith("iter")]
    check(len(rows) == 1 and metrics, f"expected one validation row: {rows}")
    return dict(seconds=[h["seconds"] for h in hist],
                iters=[h["cg_iters"] for h in hist], objectives=objectives,
                metrics=metrics, row=rows[0],
                validate_s=trainer.timer.summary()["validate"]["seconds"])


def check_main_path(res) -> None:
    obj = res["objectives"]
    check(all(math.isfinite(o) for o in obj), f"non-finite objective {obj}")
    check(all(b < a for a, b in zip(obj, obj[1:])),
          f"objective did not fall every epoch: {obj}")
    bad = {k: v for k, v in res["metrics"].items()
           if not math.isfinite(float(v))}
    check(not bad, f"non-finite metrics {bad}")


# ---------------------------------------------------------------------------
# the work of a kernel call: bytes moved and operations done
# ---------------------------------------------------------------------------


def _nbytes(a) -> int:
    import torch

    from one_class_ffm_torch.ops.layout import FeatureMajor

    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, FeatureMajor):
        return sum(_nbytes(t) for t in (a.row, a.val, a.chunk_ptr,
                                        a.feat_ptr))
    return 0


def work(name: str, args, out):
    """(bytes, operations) that the function needs on these inputs: each
    input read once and the output written once (for ``project`` only the
    table rows its ids name), and the products and sums of the entries
    these inputs hold (valid slots, nonzero X entries), not of padding."""
    import torch

    nbytes = sum(_nbytes(a) for a in args) + _nbytes(out)
    if name == "project":
        idx, val, W = args
        live = val != 0
        used = torch.unique(idx[live]).numel()
        nbytes += used * W.shape[1] * W.element_size() - _nbytes(W)
        return nbytes, 2 * W.shape[1] * int(live.sum())
    if name == "scatter":
        xt, Z = args
        return nbytes, 2 * Z.shape[1] * xt.row.numel()
    if name == "pos_hv_blocked":
        _, rows, own, _, _, num_out, bm = args[:7]
        k = rows.shape[2]
        return nbytes, (int((own < bm).sum()) * (4 * k + 2)
                        + num_out * 2 * k * k)
    if name == "pos_scatter_blocked":
        _, rows, own, _, bm = args
        return nbytes, int((own < bm).sum()) * 2 * rows.shape[2]
    if name == "pos_gap_blocked":
        _, rows, own, bm = args
        return nbytes, int((own < bm).sum()) * 2 * rows.shape[2]
    k = out.shape[1]
    xt = next(a for a in args if hasattr(a, "feat_ptr"))
    xt_ops = 2 * k * xt.row.numel()
    if name == "pos_hv_tbl":
        V, x_idx, x_val, _, rows, own, _, _, bm = args[:9]
        num = x_idx.shape[0]
        return nbytes, (2 * k * int((x_val != 0).sum())
                        + int((own < bm).sum()) * (4 * k + 2)
                        + num * 2 * k * k + xt_ops)
    if name == "grad_cross_tbl":
        _, rows, own, _, dense, bm = args
        return nbytes, (int((own < bm).sum()) * 2 * k + dense.numel()
                        + xt_ops)
    if name == "hv_self_tbl":
        _, x_idx, x_val, _, Q1, _ = args
        return nbytes, (2 * k * int((x_val != 0).sum())
                        + Q1.shape[0] * (3 * k + 2) + xt_ops)
    _, Q1, _, own, _, bm = args  # grad_self_tbl
    return nbytes, (int((own < bm).sum()) + Q1.shape[0] * (k + 1) + xt_ops)


def bound_of(nbytes: float, ops: float):
    """(least time in ms, what binds it) on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(name: str, args):
    """One PyTorch call that computes the same function on the same inputs,
    where there is one, as a yardstick (the port never calls it): a
    weighted sum of embedding rows for B8, a sparse product for the
    blocked gradient scatter and the general scatter.  Index conversion
    and the sparse matrix's structure are built here, outside the timing;
    returns the call or None."""
    import warnings

    import torch

    # the sparse tensors' constructors warn that CSR support is in beta
    warnings.filterwarnings("ignore", message="Sparse")
    if name == "project":
        idx, val, W = args
        idx_l = idx.long()
        return lambda: torch.nn.functional.embedding_bag(
            idx_l, W, mode="sum", per_sample_weights=val)
    if name == "scatter":
        xt, Z = args
        d = xt.feat_ptr.numel() - 1
        Xt = torch.sparse_csr_tensor(
            xt.chunk_ptr.long()[xt.feat_ptr.long()], xt.row.long(), xt.val,
            size=(d, Z.shape[0]))
        return lambda: torch.sparse.mm(Xt, Z)
    if name == "pos_scatter_blocked":
        c, rows, own, num_out, bm = args
        nb, maxc, k = rows.shape
        valid = (own < bm).reshape(-1)
        seg = (torch.arange(nb, device=own.device)[:, None] * bm
               + own.long()).reshape(-1)[valid]
        crow = torch.searchsorted(seg, torch.arange(
            num_out + 1, device=own.device))
        S = torch.sparse_csr_tensor(
            crow, torch.nonzero(valid).squeeze(1), c.reshape(-1)[valid],
            size=(num_out, nb * maxc))
        flat = rows.reshape(nb * maxc, k)
        return lambda: torch.sparse.mm(S, flat)
    return None


# ---------------------------------------------------------------------------
# phases on the card
# ---------------------------------------------------------------------------


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over rounds of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / reps)
    return statistics.median(out)


def new_report():
    return {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0,
                       ops=0, library_ms=None)
            for name in REPLACES}


def compare(name: str, side: str, dt_name: str, args, kw, report, gpu: str):
    """One kernel against its plain version on the same inputs: two
    launches bit-identical, max-rel within the bound; at float32 also the
    kernel, plain and library times and the work's bound."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    kern, plain = getattr(kernels, name), getattr(ops, name + "_plain")
    got, got2 = kern(*args, **kw), kern(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, got2), f"{name} {side} {dt_name}: two launches "
                                  "differ")
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{name} {side} {dt_name}: {got.shape} {got.dtype} vs plain "
          f"{ref.shape} {ref.dtype}")
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    rel = err / scale if scale > 0 else err
    r = report[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    line = (f"[kernels] {name:20s} {side} {dt_name:8s} max-rel {rel:.3e} "
            f"(bound {BOUND[dt_name]:g}) max-abs {err:.3e} bit-equal "
            f"{torch.equal(got, ref)}")
    if dt_name == "float32":
        ms = time_ms(lambda: kern(*args, **kw))
        pms = time_ms(lambda: plain(*args, **kw))
        nbytes, nops = work(name, args, got)
        bms, by = bound_of(nbytes, nops)
        lib = library_call(name, args)
        lms = time_ms(lib) if lib is not None else None
        r["ms"] += ms
        r["plain_ms"] += pms
        r["nbytes"] += nbytes
        r["ops"] += nops
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lms
        line += (f"  kernel {ms:.4f} ms  plain {pms:.4f} ms  library "
                 f"{'none' if lms is None else f'{lms:.4f} ms'}  bound "
                 f"{bms:.4f} ms by {by} ({nbytes} B, {nops} ops)  [{gpu}]")
    print(line)
    check(rel <= BOUND[dt_name],
          f"{name} {side} {dt_name}: max-rel {rel:.3e} > {BOUND[dt_name]:g}")


@contextlib.contextmanager
def first_calls(names):
    """Record the arguments of the first call of each named kernel wrapper
    while the block is run (the solver reaches the wrappers through the
    ``kernels`` module); the wrappers are restored on exit."""
    from one_class_ffm_torch.ops import kernels

    seen = {}
    saved = {name: getattr(kernels, name) for name in names}

    def recording(name, fn):
        def call(*args, **kw):
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call

    try:
        for name, fn in saved.items():
            setattr(kernels, name, recording(name, fn))
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def _cast(a, dt):
    """A recorded argument at storage dtype ``dt`` (float tensors and the
    feature-major list's values; indices and scalars as they are)."""
    import torch

    from one_class_ffm_torch.ops.layout import FeatureMajor

    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.to(dt).contiguous()
    if isinstance(a, FeatureMajor):
        return a._replace(val=a.val.to(dt))
    return a


def kernel_phase(trainer, cases, tag: str, gpu: str, report) -> None:
    """Each kernel vs its plain version on the arguments the solver gives
    it in one real half-solve (its first call there), from a fresh init.
    ``cases``: (kernel names, block, first side?, side label)."""
    import torch

    solver = trainer.solver
    state = trainer.init_state()
    sa, sb = solver.sasb(state)
    for names, b, first, side in cases:
        with first_calls(names) as seen:
            solver._solve_half(state, b, first, sa, sb)
        check(set(seen) == set(names),
              f"{tag} block {b.f12} {side}: launched {sorted(seen)}, not "
              f"{sorted(names)}")
        args = [a for name in names for a in seen[name][0]]
        stream = next((a for a in args if isinstance(a, torch.Tensor)
                       and a.dim() == 3), None)
        xt = next((a for a in args if hasattr(a, "feat_ptr")), None)
        desc = []
        if stream is not None:  # the blocked stream (n_blocks, MAXC, k)
            nb, maxc, k = stream.shape
            desc.append(f"n_blocks={nb} MAXC={maxc} k={k} slots={nb * maxc}")
        if xt is not None:  # a feature field's X^T list
            desc.append(f"D={xt.feat_ptr.numel() - 1} rows={xt.n_rows} "
                        f"X entries={xt.row.numel()} "
                        f"chunks={xt.chunk_ptr.numel() - 1}")
        if "project" in seen:
            idx = seen["project"][0][0]
            desc.append(f"project rows={idx.shape[0]} p={idx.shape[1]}")
        print(f"[kernels] {tag} {side} side, {b.kind} block {b.f12}: "
              f"{' '.join(desc)}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for name in names:
                args, kw = seen[name]
                compare(name, f"{tag} {side}", dt_name,
                        [_cast(a, dt) for a in args],
                        {key: _cast(a, dt) for key, a in kw.items()},
                        report, gpu)


def mf_cases(trainer):
    b = trainer.solver.meta.layout.cross_blocks()[0]
    return [(BLOCKED, b, True, "u"), (BLOCKED, b, False, "v")]


def ffm_cases(trainer):
    """The cross block of the two categorical fields (u side D=1000, v
    side D=500; the step's dP runs B8), and each categorical field's self
    block."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    cross = ("grad_cross_tbl", "pos_hv_tbl", "project")
    self_ = ("grad_self_tbl", "hv_self_tbl")
    return [(cross, blocks[(1, fu + 1)], True, "u"),
            (cross, blocks[(1, fu + 1)], False, "v"),
            (self_, blocks[(1, 1)], True, "u"),
            (self_, blocks[(fu + 1, fu + 1)], True, "v")]


def fm_cases(trainer):
    """The cross block of the two wide fields, both sides: every CG
    iteration projects (B8), runs B1 and scatters (the X^T stage)."""
    b = trainer.solver.meta.layout.cross_blocks()[0]
    names = BLOCKED + WIDE
    return [(names, b, True, "u"), (names, b, False, "v")]


def _dense_fields(pf):
    """Dense (m_true, D) matrices of a side's padded fields (pad slots and
    rows add nothing)."""
    import numpy as np

    out = []
    for fi in range(pf.f):
        X = np.zeros((pf.m_true, pf.Ds[fi]))
        idx, val = pf.idx[fi][: pf.m_true], pf.val[fi][: pf.m_true]
        rows = np.repeat(np.arange(pf.m_true), idx.shape[1])
        np.add.at(X, (rows, idx.reshape(-1)), val.reshape(-1))
        out.append(X)
    return out


def reference_phase(device, tag: str) -> None:
    """Small MF problem, small FFM problem with self blocks, or small FM
    problem with self blocks whose fields are above a lowered fused-table
    cap: the kernel-driven gradient and Hv of every block side and the
    tracked objective on the card against the fp64 numpy oracle."""
    import numpy as np
    import torch

    from one_class_ffm_torch.solver import oracle
    from one_class_ffm_torch.solver.convert import params_to_numpy

    if tag == "MF":
        data = build_data(2048, 512, 5.0, seed=3)
        tr = make_trainer(data, device, k=8)
    else:
        data = build_data(1024, 256, 5.0, seed=3, dims_u=(1024, 40),
                          dims_v=(256, 24), self_side=True, fm=tag == "FM")
        with fused_cap(8) if tag == "FM" else contextlib.nullcontext():
            tr = make_trainer(data, device, k=8)
    solver = tr.solver
    if tag == "FM":
        check(not any(solver.meta.fused_u + solver.meta.fused_v),
              "FM reference: a field took the fused table passes")
    state = tr.init_state()
    m, n = data.m_users_true, data.n_items_true
    pos = np.zeros((m, n), bool)
    w = data.y_pad.w > 0
    pos[data.y_pad.u[w], data.y_pad.v[w]] = True
    prob = oracle.OracleProblem(
        layout=data.layout, hp=tr.cfg.hyper(), Xu=_dense_fields(data.u_pad),
        Xv=_dense_fields(data.v_pad), pos=pos,
        freq_u=[np.asarray(f, np.float64) for f in data.u_pad.freq],
        freq_v=[np.asarray(f, np.float64) for f in data.v_pad.freq])

    def dense_params(st):
        p = params_to_numpy(st["params"])
        return {"W": {f: blk["W"].astype(np.float64) for f, blk in p.items()},
                "H": {f: blk["H"].astype(np.float64) for f, blk in p.items()}}

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    sa, sb = solver.sasb(state)
    ref_params = dense_params(state)
    rng = np.random.default_rng(4)
    worst_g = worst_h = 0.0
    for b in data.layout.all_blocks():
        for first in (True, False):
            G, hv, _ = solver.grad_and_hv(state, b, first, sa, sb)
            G_ref, hv_ref = oracle.grad_and_hv(prob, ref_params, b, first)
            V = rng.normal(size=G_ref.shape)
            H = hv(torch.as_tensor(V, dtype=solver.meta.dtype,
                                   device=device))
            worst_g = max(worst_g, rel(G.double().cpu().numpy(), G_ref))
            worst_h = max(worst_h, rel(H.double().cpu().numpy(),
                                       hv_ref(V)))
    print(f"[reference] {tag}: {len(data.layout.all_blocks())} blocks x 2 "
          f"sides vs fp64 oracle: gradient max-rel {worst_g:.3e}, Hv "
          f"max-rel {worst_h:.3e}")
    check(worst_g < 1e-4, f"{tag} gradient disagrees with the oracle: "
                          f"{worst_g:.3e}")
    check(worst_h < 1e-4, f"{tag} Hv disagrees with the oracle: "
                          f"{worst_h:.3e}")
    for ep in range(2):
        state = solver.epoch(state)
        got = float(solver.objective(state))
        ref = oracle.objective(prob, dense_params(state))
        r = abs(got - ref) / abs(ref)
        print(f"[reference] {tag} epoch {ep + 1} objective {got:.6f} vs "
              f"oracle {ref:.6f}: rel {r:.3e}")
        check(r < 1e-4, f"{tag} tracked objective disagrees with the "
                        f"oracle: {r:.3e}")


def profile_epoch(tag: str, trainer, gpu: str) -> None:
    """One more epoch under torch.profiler: the device's idle share (1 -
    the union of the kernels' intervals over the window) and the kernels
    that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, _ = trainer.solver.epoch_stats(trainer.state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        print(f"[main {tag}] profiled epoch {wall:.4f} s: no device events "
              f"in the trace, idle share not measured [{gpu}]")
        return
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for s, e in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    print(f"[main {tag}] profiled epoch {wall:.4f} s: device busy "
          f"{busy / 1e3:.3f} ms of {(hi - lo) / 1e3:.3f} ms, idle share "
          f"{1.0 - busy / (hi - lo):.4f} [{gpu}]")
    rows = sorted(prof.key_averages(),
                  key=lambda a: a.self_device_time_total, reverse=True)
    for a in rows[:8]:
        if a.self_device_time_total <= 0:
            break
        print(f"[main {tag}]   {a.self_device_time_total / 1e3:9.3f} ms "
              f"{a.count:6d} calls  {a.key[:90]}")


def main_path(tag: str, trainer, names, gpu: str, epochs: int = 3):
    """Train and validate, with every launch count set to 0 just before
    and read just after; each kernel in ``names`` must have launched."""
    from one_class_ffm_torch.ops import kernels

    kernels.reset_launch_counts()
    res = train_and_validate(trainer, epochs=epochs)
    launches = kernels.launch_counts()
    for i, (s, it) in enumerate(zip(res["seconds"], res["iters"])):
        print(f"[main {tag}] epoch {i + 1}: {s:.4f} s, CG iterations per "
              f"solve {it}, objective {res['objectives'][i + 1]:.6f} [{gpu}]")
    print(f"[main {tag}] objective at init {res['objectives'][0]:.6f}")
    print(f"[main {tag}] validation {res['validate_s']:.4f} s")
    print(f"[main {tag}] {res['row']}")
    print(f"[main {tag}] metrics {json.dumps(res['metrics'])}")
    print(f"[main {tag}] kernel launches {launches}")
    check_main_path(res)
    for name in names:
        check(launches[name] > 0,
              f"{name} never launched on the {tag} main path")
    profile_epoch(tag, trainer, gpu)
    return launches


def write_fm_dataset(work: str, spec):
    """Text files of the FM encoding: the synthetic rows with all of a
    side's features in one field, offset ids (scripts/parity_check.py
    flatten_fields), split as ``write_dataset`` splits."""
    import numpy as np

    from one_class_ffm_torch.data.synth import _write_rows, generate

    def flat(rows, dims):
        offs = np.concatenate([[0], np.cumsum(dims)[:-1]])
        return [(lab, [(0, int(offs[f]) + i, v) for f, i, v in feats])
                for lab, feats in rows]

    du, dv = spec.resolve()
    users, items = generate(spec)
    rng = np.random.default_rng(spec.seed + 1)
    tr_rows, va_rows = [], []
    for labels, feats in flat(users, du):
        labels = list(labels)
        rng.shuffle(labels)
        n_va = int(len(labels) * 0.2)
        if len(labels) - n_va < 1:
            n_va = max(0, len(labels) - 1)
        tr_rows.append((sorted(labels[n_va:]), feats))
        if n_va:
            va_rows.append((sorted(labels[:n_va]), feats))
    os.makedirs(work, exist_ok=True)
    _write_rows(os.path.join(work, "items.ffm"), flat(items, dv), False)
    _write_rows(os.path.join(work, "train.ffm"), tr_rows, True)
    _write_rows(os.path.join(work, "va.ffm"), va_rows, True)


def cli_phase() -> None:
    """The command line on small text datasets: MF --ns, FFM, and FM whose
    user field (5,050 features) is above the fused-table cap."""
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for tag, flags in (("mf", ["--ns"]), ("ffm", []), ("fm", [])):
        work = os.path.join(WORK, "cli_" + tag)
        os.makedirs(work, exist_ok=True)
        if tag == "fm":
            write_fm_dataset(work, SynthSpec(n_users=5000, n_items=300,
                                             avg_pos=6.0, seed=1))
        else:
            fields = 1 if tag == "mf" else 2
            write_dataset(work, SynthSpec(n_users=2000, n_items=300,
                                          fu=fields, fv=fields, avg_pos=6.0,
                                          seed=1))
        cmd = [sys.executable, "-m", "one_class_ffm_torch", "items.ffm",
               "train.ffm", "-p", "va.ffm", *flags, "-k", "8", "-t", "2",
               "--eval-every", "1", "--verbose"]
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                              text=True, timeout=600)
        for line in proc.stdout.strip().splitlines():
            print(f"[cli {tag}] {line}")
        check(proc.returncode == 0,
              f"{tag} CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        rows = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("iter") or ln.startswith(" ")]
        check(len(rows) == 3, f"{tag} CLI printed no header + 2 rows")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "one_class_ffm_torch")):
        print("chip_smoke: FAIL: one_class_ffm_torch/ is not beside this "
              "script (run it from a checkout of the repository)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    try:
        # 1. device
        device = torch.device("cuda", 0)
        gpu = gpu_line()
        print(f"[device] {gpu}")
        print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} "
              f"{torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # 2. build
        from one_class_ffm_torch.ops import kernels
        from one_class_ffm_torch.ops.layout import feature_major

        kernels.load()
        print(f"[build] {kernels.library_path().name} in "
              f"{kernels.build_seconds:.2f} s")

        # 3. kernels vs plain at the slices' shapes
        report = new_report()
        t0 = time.perf_counter()
        mf = build_data(N_USERS, N_ITEMS, 5.0, seed=0)
        ffm = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                         **FFM_DIMS)
        fm = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                        fm=True, **FFM_DIMS)
        print(f"[data] MF {N_USERS} x {N_ITEMS}: {mf.nnz_true} training "
              f"positives, {len(mf.va_labels)} test users; FFM "
              f"{ffm.u_pad.Ds} x {ffm.v_pad.Ds}: {ffm.nnz_true} training "
              f"positives, {len(ffm.va_labels)} test users; FM "
              f"{fm.u_pad.Ds} x {fm.v_pad.Ds} (p = {fm.u_pad.idx[0].shape[1]}"
              f" / {fm.v_pad.idx[0].shape[1]}); "
              f"{time.perf_counter() - t0:.1f} s")
        for side, pf in (("u", fm.u_pad), ("v", fm.v_pad)):
            t0 = time.perf_counter()
            fmj = feature_major(pf.idx[0], pf.val[0], pf.Ds[0])
            print(f"[data] FM {side} field: feature-major list of "
                  f"{fmj.row.size} entries in {fmj.chunk_ptr.size - 1} "
                  f"chunks over D={pf.Ds[0]} built in "
                  f"{time.perf_counter() - t0:.3f} s (numpy, once per run)")
        mf_trainer = make_trainer(mf, device)
        ffm_trainer = make_trainer(ffm, device)
        t0 = time.perf_counter()
        fm_trainer = make_trainer(fm, device)
        print(f"[data] FM trainer (device data, both lists, evaluator) in "
              f"{time.perf_counter() - t0:.2f} s")
        meta = fm_trainer.solver.meta
        check(not any(meta.fused_u + meta.fused_v + meta.ident_u
                      + meta.ident_v),
              "FM: a field is identity or takes the fused table passes")
        kernel_phase(mf_trainer, mf_cases(mf_trainer), "MF", gpu, report)
        kernel_phase(ffm_trainer, ffm_cases(ffm_trainer), "FFM", gpu, report)
        kernel_phase(fm_trainer, fm_cases(fm_trainer), "FM", gpu, report)

        # 4. small-input references
        for tag in ("MF", "FFM", "FM"):
            reference_phase(device, tag)

        # 5.-7. the main paths at full width, each with its own counts
        launches = {name: 0 for name in REPLACES}
        for tag, trainer, names in (
                ("mf", mf_trainer, BLOCKED + ("project",)),
                ("ffm", ffm_trainer, BLOCKED + TABLE + ("project",)),
                ("fm", fm_trainer, BLOCKED + WIDE)):
            got = main_path(tag, trainer, names, gpu)
            for name in REPLACES:
                launches[name] += got[name]

        # 8. the command-line entry point
        cli_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"[device] {gpu}")
    entries = []
    for name in REPLACES:
        r = report[name]
        bms, by = bound_of(r["nbytes"], r["ops"])
        entries.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=r["library_ms"]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
