#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check every part of it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card at the
   MF slice's real shapes (200k users x 20k items, k=32, both solve sides),
   at float32 (max-rel <= 1e-5) and bfloat16 (<= 5e-3), bit-identical on
   repeat, with kernel and plain times (CUDA events);
4. reference: on a small MF problem, the gradient the kernels give on the
   card matches the fp64 numpy oracle, and the objective the solver tracks
   through two kernel-driven epochs matches the oracle's brute-force loss;
5. main path: the port's Trainer trains MF --ns at 200,000 users x 20,000
   items, ~5 positives per user, k=32, float32 for 3 epochs and validates
   once; every kernel must have launched, the objective must fall every
   epoch and every metric must be finite;
6. entry point: ``python -m one_class_ffm_torch ... --ns`` on a small text
   dataset must exit 0.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the one_class_ffm_torch package beside this file, it exits 1 and
prints no result.  Nothing here imports jax.
"""

from __future__ import annotations

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
# wrapper in the JAX package)
REPLACES = {
    "pos_hv_blocked": "one_class_ffm_tpu/ops/sparse_ops.py:1507",
    "pos_scatter_blocked": "one_class_ffm_tpu/ops/sparse_ops.py:1623",
    "pos_gap_blocked": "one_class_ffm_tpu/ops/sparse_ops.py:1786",
}
SOURCE = "one_class_ffm_torch/csrc/blocked_ops.cu"
BOUND = {"float32": 1e-5, "bfloat16": 5e-3}  # max-rel, scripts/kt_debug.py


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data: synthetic MF with a held-out validation split, built in memory
# ---------------------------------------------------------------------------


def build_mf_data(n_users: int, n_items: int, avg_pos: float, seed: int,
                  row_multiple: int = 256, va_frac: float = 0.2):
    """LoadedData for one-class MF (one identity id field per side) from
    ``generate_vectorized``, with a fraction of each user's positives held
    out for validation as ``write_dataset`` does (users keep >= 1 training
    positive; users with no held-out label are not test users)."""
    import numpy as np

    from one_class_ffm_tpu.data.dataset import (
        Interactions,
        PaddedFields,
        pad_labels,
    )
    from one_class_ffm_tpu.data.synth import SynthSpec, generate_vectorized
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.train import LoadedData

    spec = SynthSpec(n_users=n_users, n_items=n_items, fu=1, fv=1,
                     avg_pos=avg_pos, seed=seed)
    _, u_pad, v_pad, y_all = generate_vectorized(
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
    idx = np.zeros((mt_pad, 1), np.int32)
    val = np.zeros((mt_pad, 1), np.float32)
    idx[:mt, 0] = va_users
    val[:mt, 0] = 1.0
    row_nnz = np.zeros(mt_pad, np.int32)
    row_nnz[:mt] = 1
    uva = PaddedFields(m=mt_pad, m_true=mt, f=1, Ds=(n_users,), idx=(idx,),
                       val=(val,), freq=u_pad.freq, row_nnz=row_nnz)
    return LoadedData(
        layout=BlockLayout.make([n_users], [n_items], False), u_pad=u_pad,
        v_pad=v_pad, y_pad=y_pad, popular=popular, uva_pad=uva,
        va_labels=va_labels, n_items_true=n_items, m_users_true=n_users,
        nnz_true=y_pad.nnz_true)


def make_trainer(data, device, k: int = 32, dtype: str = "float32",
                 epochs: int = 3):
    from one_class_ffm_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(item_path="<memory>", train_path="<memory>", k=k,
                      lam=0.05, omega=0.1, r=-1.0, nr_pass=epochs,
                      self_side=False, dtype=dtype, eval_every=epochs,
                      seed=0)
    return Trainer(cfg, data=data, device=device)


def train_and_validate(trainer, epochs: int):
    """The main path through ``Trainer.run``, one epoch per call (``run``
    continues from ``epoch_idx`` up to ``cfg.nr_pass``, as a resumed run
    does), reading the objective between epochs; the trainer validates at
    its ``eval_every`` epoch.  Returns per-epoch seconds, CG iteration
    counts and objectives, the metrics and the log row."""
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
                metrics=metrics, row=rows[0])


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


def kernel_phase(trainer, gpu: str):
    """Each kernel vs its plain version at both sides' real shapes."""
    import torch

    from one_class_ffm_torch.ops import sparse_ops as ops

    solver, d = trainer.solver, trainer.solver.data
    state = trainer.init_state()
    b = solver.meta.layout.cross_blocks()[0]
    hp = solver.meta.hp
    report = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
              for name in REPLACES}
    for first in (True, False):
        side = "u" if first else "v"
        pre, num, bm = solver._blk(first)
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        rows32 = ops.gather_blocked_rows(B1, d[pre + "take"])
        # the first CG direction, padded to the stream's row count
        G = solver._proj(b, first,
                         solver._grad_cross(state, b, first, rows32)).float()
        own = d[pre + "own"]
        base = dict(
            rows=rows32, phi=G, w=d[pre + "w"],
            dense=(hp.omega * (B1.T @ B1)).float(),
            c=solver._pos_coeff(state["yt_" + side]) * d[pre + "w"],
            dP=1e-3 * G)
        nb, maxc, k = rows32.shape
        print(f"[kernels] {side} side: n_blocks={nb} MAXC={maxc} k={k} "
              f"rows={num} slots={nb * maxc}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            x = {key: t.to(dt).contiguous() for key, t in base.items()}
            calls = {
                "pos_hv_blocked": lambda f, x=x: f(
                    x["phi"], x["rows"], own, x["w"], x["dense"], num, bm,
                    1.0 - hp.omega),
                "pos_scatter_blocked": lambda f, x=x: f(
                    x["c"], x["rows"], own, num, bm),
                "pos_gap_blocked": lambda f, x=x: f(
                    x["dP"], x["rows"], own, bm),
            }
            from one_class_ffm_torch.ops import kernels

            for name, call in calls.items():
                kern = getattr(kernels, name)
                plain = getattr(ops, name + "_plain")
                got, got2 = call(kern), call(kern)
                ref = call(plain)
                torch.cuda.synchronize()
                check(torch.equal(got, got2),
                      f"{name} {side} {dt_name}: two launches differ")
                err = (got.double() - ref.double()).abs().max().item()
                scale = ref.double().abs().max().item()
                rel = err / scale if scale > 0 else err
                ms, pms = time_ms(lambda: call(kern)), time_ms(
                    lambda: call(plain))
                print(f"[kernels] {name:20s} {side} {dt_name:8s} "
                      f"max-rel {rel:.3e} (bound {BOUND[dt_name]:g}) "
                      f"max-abs {err:.3e} bit-equal "
                      f"{torch.equal(got, ref)}  kernel {ms:.4f} ms  plain "
                      f"{pms:.4f} ms  [{gpu}]")
                check(rel <= BOUND[dt_name],
                      f"{name} {side} {dt_name}: max-rel {rel:.3e} > "
                      f"{BOUND[dt_name]:g}")
                if dt_name == "float32":
                    r = report[name]
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    r["ms"] += ms
                    r["plain_ms"] += pms
    return report


def reference_phase(device) -> None:
    """Small MF problem: kernel-driven gradient and tracked objective on the
    card against the fp64 numpy oracle."""
    import numpy as np
    import torch

    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_torch.ops import sparse_ops as ops
    from one_class_ffm_torch.solver.convert import params_to_numpy

    data = build_mf_data(2048, 512, 5.0, seed=3)
    tr = make_trainer(data, device, k=8)
    solver = tr.solver
    state = tr.init_state()
    m, n = data.m_users_true, data.n_items_true
    pos = np.zeros((m, n), bool)
    w = data.y_pad.w > 0
    pos[data.y_pad.u[w], data.y_pad.v[w]] = True
    prob = oracle.OracleProblem(layout=data.layout, hp=tr.cfg.hyper(),
                                Xu=[np.eye(m)], Xv=[np.eye(n)], pos=pos)

    def dense_params(st):
        p = params_to_numpy(st["params"])
        return {"W": {f: blk["W"].astype(np.float64) for f, blk in p.items()},
                "H": {f: blk["H"].astype(np.float64) for f, blk in p.items()}}

    b = data.layout.cross_blocks()[0]
    for first in (True, False):
        pre = "blk_u_" if first else "blk_v_"
        B1 = state["Q"][b.f12] if first else state["P"][b.f12]
        rows = ops.gather_blocked_rows(B1, solver.data[pre + "take"])
        G = solver._grad_cross(state, b, first, rows).double().cpu().numpy()
        G_ref, _ = oracle.grad_and_hv(prob, dense_params(state), b, first)
        rel = np.abs(G - G_ref).max() / np.abs(G_ref).max()
        print(f"[reference] gradient {'W' if first else 'H'} vs fp64 oracle:"
              f" max-rel {rel:.3e}")
        check(rel < 1e-4, f"gradient disagrees with the oracle: {rel:.3e}")
    for ep in range(2):
        state = solver.epoch(state)
        got = float(solver.objective(state))
        ref = oracle.objective(prob, dense_params(state))
        rel = abs(got - ref) / abs(ref)
        print(f"[reference] epoch {ep + 1} objective {got:.6f} vs oracle "
              f"{ref:.6f}: rel {rel:.3e}")
        check(rel < 1e-4, f"tracked objective disagrees with the oracle: "
                          f"{rel:.3e}")


def cli_phase() -> None:
    from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset

    work = os.path.join(WORK, "cli")
    os.makedirs(work, exist_ok=True)
    write_dataset(work, SynthSpec(n_users=2000, n_items=300, fu=1, fv=1,
                                  avg_pos=6.0, seed=1))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "one_class_ffm_torch", "items.ffm",
           "train.ffm", "-p", "va.ffm", "--ns", "-k", "8", "-t", "2",
           "--eval-every", "1"]
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
        print(f"[cli] {line}")
    check(proc.returncode == 0,
          f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    check(len(proc.stdout.strip().splitlines()) == 3,
          "CLI printed no header + 2 rows")


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

        # 3. kernels vs plain at the slice's shapes
        t0 = time.perf_counter()
        data = build_mf_data(200_000, 20_000, 5.0, seed=0)
        print(f"[data] MF 200000 x 20000: {data.nnz_true} training "
              f"positives, {len(data.va_labels)} test users, "
              f"{time.perf_counter() - t0:.1f} s")
        trainer = make_trainer(data, device)
        report = kernel_phase(trainer, gpu)

        # 4. small-input reference
        reference_phase(device)

        # 5. the main path at full width
        kernels.reset_launch_counts()
        res = train_and_validate(trainer, epochs=3)
        launches = kernels.launch_counts()
        for i, (s, it) in enumerate(zip(res["seconds"], res["iters"])):
            print(f"[main] epoch {i + 1}: {s:.4f} s, CG iterations per "
                  f"solve {it}, objective {res['objectives'][i + 1]:.6f} "
                  f"[{gpu}]")
        print(f"[main] objective at init {res['objectives'][0]:.6f}")
        print(f"[main] {res['row']}")
        print(f"[main] metrics {json.dumps(res['metrics'])}")
        print(f"[main] kernel launches {launches}")
        check_main_path(res)
        for name, count in launches.items():
            check(count > 0, f"{name} never launched on the main path")

        # 6. the command-line entry point
        cli_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"[device] {gpu}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], **report[name])
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
