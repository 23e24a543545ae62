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
   (max-rel <= 1e-5) and bfloat16 (<= 5e-3), bit-identical on repeat, with
   kernel and plain times (CUDA events): the three blocked kernels in MF
   solves (200k users x 20k items, k=32, both solve sides), the four fused
   table kernels in FFM solves (the same rows, u-side field D=1000 and
   v-side field D=500, p=3, both sides);
4. reference: on a small MF problem and a small FFM problem with self
   blocks, the gradients and Hv products the kernels give on the card match
   the fp64 numpy oracle, and the objective the solver tracks through two
   kernel-driven epochs matches the oracle's brute-force loss;
5. main path, MF: the port's Trainer trains MF --ns at 200,000 users x
   20,000 items, ~5 positives per user, k=32, float32 for 3 epochs and
   validates once; its three kernels must have launched;
6. main path, FFM: the Trainer trains the bench headline FFM (2 user and 2
   item fields, self blocks) at the same sizes for 3 epochs and validates
   once; all seven kernels must have launched.  On both paths the
   objective must fall every epoch and every metric must be finite;
7. entry point: ``python -m one_class_ffm_torch`` on small text datasets,
   MF with --ns and FFM without, must exit 0.

The line before the last is a JSON object with one entry per kernel (its
launches counted on the FFM main path, which runs all seven); the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the one_class_ffm_torch package beside this file, it exits 1 and prints no
result.  Nothing here imports jax.
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

# per kernel: the Pallas kernel it replaces (file:line of the pallas_call
# wrapper of the twin the TPU path ships, in the JAX package) and its source
_JAX_OPS = "one_class_ffm_tpu/ops/sparse_ops.py"
REPLACES = {
    "pos_hv_blocked": f"{_JAX_OPS}:1507",
    "pos_scatter_blocked": f"{_JAX_OPS}:1623",
    "pos_gap_blocked": f"{_JAX_OPS}:1786",
    "pos_hv_tbl": f"{_JAX_OPS}:1566",
    "grad_cross_tbl": f"{_JAX_OPS}:1695",
    "hv_self_tbl": f"{_JAX_OPS}:1836",
    "grad_self_tbl": f"{_JAX_OPS}:1900",
}
BLOCKED = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked")
TABLE = ("pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl")
SOURCE = {name: "one_class_ffm_torch/csrc/"
          + ("blocked_ops.cu" if name in BLOCKED else "table_ops.cu")
          for name in REPLACES}
BOUND = {"float32": 1e-5, "bfloat16": 5e-3}  # max-rel, scripts/kt_debug.py

# the bench headline FFM (bench.py): field 0 of each side is the id field,
# field 1 a categorical field of 1000 (users) / 500 (items) features
N_USERS, N_ITEMS = 200_000, 20_000
FFM_DIMS = dict(dims_u=(N_USERS, 1000), dims_v=(N_ITEMS, 500))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data: synthetic MF / FFM with a held-out validation split, built in memory
# ---------------------------------------------------------------------------


def build_data(n_users: int, n_items: int, avg_pos: float, seed: int,
               dims_u=None, dims_v=None, self_side: bool = False,
               row_multiple: int = 256, va_frac: float = 0.2):
    """LoadedData from ``generate_vectorized``: one identity id field per
    side (MF) unless ``dims_u``/``dims_v`` name more fields, with a fraction
    of each user's positives held out for validation as ``write_dataset``
    does (users keep >= 1 training positive; users with no held-out label
    are not test users; test users keep their feature rows)."""
    import numpy as np

    from one_class_ffm_tpu.data.dataset import (
        Interactions,
        PaddedFields,
        pad_labels,
    )
    from one_class_ffm_tpu.data.synth import SynthSpec, generate_vectorized
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.train import LoadedData

    spec = SynthSpec(n_users=n_users, n_items=n_items,
                     fu=len(dims_u) if dims_u else 1,
                     fv=len(dims_v) if dims_v else 1,
                     dims_u=dims_u, dims_v=dims_v, avg_pos=avg_pos, seed=seed)
    (du, dv), u_pad, v_pad, y_all = generate_vectorized(
        spec, np.float32, row_multiple=row_multiple)
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
# phases on the card
# ---------------------------------------------------------------------------


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over rounds of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
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


def compare(name: str, side: str, dt_name: str, call, report, gpu: str):
    """One kernel against its plain version on the same inputs: two
    launches bit-identical, max-rel within the bound, both timed.  ``call``
    takes the function to call (the kernel's wrapper or the plain
    version)."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    kern, plain = getattr(kernels, name), getattr(ops, name + "_plain")
    got, got2 = call(kern), call(kern)
    ref = call(plain)
    torch.cuda.synchronize()
    check(torch.equal(got, got2), f"{name} {side} {dt_name}: two launches "
                                  "differ")
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{name} {side} {dt_name}: {got.shape} {got.dtype} vs plain "
          f"{ref.shape} {ref.dtype}")
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    rel = err / scale if scale > 0 else err
    ms, pms = time_ms(lambda: call(kern)), time_ms(lambda: call(plain))
    print(f"[kernels] {name:20s} {side} {dt_name:8s} max-rel {rel:.3e} "
          f"(bound {BOUND[dt_name]:g}) max-abs {err:.3e} bit-equal "
          f"{torch.equal(got, ref)}  kernel {ms:.4f} ms  plain {pms:.4f} ms"
          f"  [{gpu}]")
    check(rel <= BOUND[dt_name],
          f"{name} {side} {dt_name}: max-rel {rel:.3e} > {BOUND[dt_name]:g}")
    if dt_name == "float32":
        r = report[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms


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
        desc = " ".join(desc)
        print(f"[kernels] {tag} {side} side, {b.kind} block {b.f12}: {desc}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for name in names:
                args, kw = seen[name]
                args = [_cast(a, dt) for a in args]
                kw = {key: _cast(a, dt) for key, a in kw.items()}
                compare(name, side, dt_name,
                        lambda f, args=args, kw=kw: f(*args, **kw), report,
                        gpu)


def mf_cases(trainer):
    b = trainer.solver.meta.layout.cross_blocks()[0]
    return [(BLOCKED, b, True, "u"), (BLOCKED, b, False, "v")]


def ffm_cases(trainer):
    """The cross block of the two categorical fields (u side D=1000, v
    side D=500), and each categorical field's self block."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    cross = ("grad_cross_tbl", "pos_hv_tbl")
    self_ = ("grad_self_tbl", "hv_self_tbl")
    return [(cross, blocks[(1, fu + 1)], True, "u"),
            (cross, blocks[(1, fu + 1)], False, "v"),
            (self_, blocks[(1, 1)], True, "u"),
            (self_, blocks[(fu + 1, fu + 1)], True, "v")]


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


def reference_phase(device, ffm: bool) -> None:
    """Small MF problem, or small FFM problem with self blocks: the
    kernel-driven gradient and Hv of every block side and the tracked
    objective on the card against the fp64 numpy oracle."""
    import numpy as np
    import torch

    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_torch.solver.convert import params_to_numpy

    tag = "FFM" if ffm else "MF"
    if ffm:
        data = build_data(1024, 256, 5.0, seed=3, dims_u=(1024, 40),
                          dims_v=(256, 24), self_side=True)
    else:
        data = build_data(2048, 512, 5.0, seed=3)
    tr = make_trainer(data, device, k=8)
    solver = tr.solver
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


def main_path(tag: str, trainer, names, gpu: str):
    """Train 3 epochs and validate, with every launch count set to 0 just
    before and read just after; each kernel in ``names`` must have
    launched."""
    from one_class_ffm_torch.ops import kernels

    kernels.reset_launch_counts()
    res = train_and_validate(trainer, epochs=3)
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
    return launches


def cli_phase() -> None:
    from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for tag, fields, flags in (("mf", 1, ["--ns"]), ("ffm", 2, [])):
        work = os.path.join(WORK, "cli_" + tag)
        os.makedirs(work, exist_ok=True)
        write_dataset(work, SynthSpec(n_users=2000, n_items=300, fu=fields,
                                      fv=fields, avg_pos=6.0, seed=1))
        cmd = [sys.executable, "-m", "one_class_ffm_torch", "items.ffm",
               "train.ffm", "-p", "va.ffm", *flags, "-k", "8", "-t", "2",
               "--eval-every", "1"]
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                              text=True, timeout=600)
        for line in proc.stdout.strip().splitlines():
            print(f"[cli {tag}] {line}")
        check(proc.returncode == 0,
              f"{tag} CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        check(len(proc.stdout.strip().splitlines()) == 3,
              f"{tag} CLI printed no header + 2 rows")


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

        kernels.load()
        print(f"[build] {kernels.library_path().name} in "
              f"{kernels.build_seconds:.2f} s")

        # 3. kernels vs plain at the slices' shapes
        report = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
                  for name in REPLACES}
        t0 = time.perf_counter()
        mf = build_data(N_USERS, N_ITEMS, 5.0, seed=0)
        ffm = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                         **FFM_DIMS)
        print(f"[data] MF {N_USERS} x {N_ITEMS}: {mf.nnz_true} training "
              f"positives, {len(mf.va_labels)} test users; FFM "
              f"{ffm.u_pad.Ds} x {ffm.v_pad.Ds}: {ffm.nnz_true} training "
              f"positives, {len(ffm.va_labels)} test users; "
              f"{time.perf_counter() - t0:.1f} s")
        mf_trainer = make_trainer(mf, device)
        ffm_trainer = make_trainer(ffm, device)
        kernel_phase(mf_trainer, mf_cases(mf_trainer), "MF", gpu, report)
        kernel_phase(ffm_trainer, ffm_cases(ffm_trainer), "FFM", gpu, report)

        # 4. small-input references
        reference_phase(device, ffm=False)
        reference_phase(device, ffm=True)

        # 5.-6. the main paths at full width, each with its own counts
        main_path("mf", mf_trainer, BLOCKED, gpu)
        launches = main_path("ffm", ffm_trainer, tuple(REPLACES), gpu)

        # 7. the command-line entry point
        cli_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"[device] {gpu}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE[name],
             replaces=REPLACES[name], launches=launches[name],
             **report[name])
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
