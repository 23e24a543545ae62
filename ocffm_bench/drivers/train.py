"""Training traffic: jobs of ``epochs_per_job`` epochs on the full data.

Set-up makes the data and the start tables from the seed, builds one
``Trainer`` on an in-memory ``LoadedData`` and runs the first job from the
initial tables: it builds every kernel and captures every CUDA graph, and
the tables after its first ``check_steps`` epochs, and after its last, are
kept on the host.  The window then runs whole jobs, each restoring the
initial tables on the card through ``solver.refresh_caches`` and stepping
``solver.epoch_stats`` epoch by epoch, until ``--seconds`` have passed at
a job's end.  ``train_examples_per_s`` is users x epochs completed over
the window.  Once the window has closed and the peak memory is read, the
last job's final tables are held against the set-up job's (``repeat_gap``:
the program is deterministic, so every job of the window gives the first
job's tables), the program is freed and the reference follows the same
``check_steps`` epochs from the same tables in float64; the comparison is
``compare``'s.

Hooks (``ctx.hooks``, for the tests and ``calibrate.py``):
``program_problem`` maps the problem that the program is handed,
``solver`` receives the program's solver, ``outputs(outputs, problem,
init)`` replaces the tables that the comparison takes as the program's,
and ``detail``, a list, receives ``compare``'s per-epoch detail.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import gen, trace, work
from ..harness import Check, Context, DriverResult
from ..reference.ffm_ref import Reference, start_tables, table_dims


def hyper(cfg: dict) -> dict:
    return {key: cfg[key] for key in ("k", "lam", "omega", "r", "cg_eps",
                                      "cg_max_iter", "self_side")}


def program_input(problem: gen.Problem, cfg: dict):
    """The program's ``LoadedData``: rows padded to the Trainer's multiple
    (``blocked_bm``), the stream to eight times it."""
    from one_class_ffm_torch.data.dataset import (Interactions, PaddedFields,
                                                  pad_labels)
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.train import LoadedData

    mult = int(cfg["blocked_bm"])

    def padded(side: gen.Side) -> PaddedFields:
        rows = -(-side.rows // mult) * mult
        idx, val, freq = [], [], []
        for i, v, d in zip(side.idx, side.val, side.dims):
            I = np.zeros((rows, i.shape[1]), np.int32)
            V = np.zeros((rows, i.shape[1]), np.float32)
            I[: side.rows], V[: side.rows] = i, v
            idx.append(I)
            val.append(V)
            freq.append(np.bincount(i.ravel(), minlength=d)
                        .astype(np.float32))
        nnz = np.zeros(rows, np.int32)
        nnz[: side.rows] = sum(i.shape[1] for i in side.idx)
        return PaddedFields(m=rows, m_true=side.rows, f=len(side.dims),
                            Ds=tuple(side.dims), idx=tuple(idx),
                            val=tuple(val), freq=tuple(freq), row_nnz=nnz)

    u_pad, v_pad = padded(problem.users), padded(problem.items)
    m, n = problem.users.rows, problem.items.rows
    indptr = np.concatenate([[0], np.cumsum(np.bincount(problem.pos_u,
                                                        minlength=m))])
    y = Interactions(m=m, n=n, indptr=indptr.astype(np.int64),
                     col=problem.pos_v.astype(np.int64))
    y_pad = pad_labels(y, u_pad.m, v_pad.m, nnz_multiple=mult * 8,
                       dtype=np.float32)
    layout = BlockLayout.make(problem.users.dims, problem.items.dims,
                              bool(cfg["self_side"]))
    return LoadedData(layout=layout, u_pad=u_pad, v_pad=v_pad, y_pad=y_pad,
                      popular=problem.popular, uva_pad=None, va_labels=None,
                      n_items_true=n, m_users_true=m,
                      nnz_true=int(problem.pos_u.shape[0]))


def host_tables(params, dims) -> Dict[int, Dict[str, torch.Tensor]]:
    """The tables at their true dims, float32, on the host."""
    return {f12: {"W": params[f12]["W"][:d1].float().cpu(),
                  "H": params[f12]["H"][:d2].float().cpu()}
            for f12, (d1, d2) in dims.items()}


def compare(ref: Reference, init, outputs: List[dict],
            ref_tables: Optional[List[dict]] = None,
            detail: Optional[list] = None):
    """The numbers compared after ``len(outputs)`` epochs from ``init``:

    - ``loss_gap``: over the epochs, the largest |L(program) - L(reference)|
      / L(reference), L the reference's float64 loss of each side's tables;
    - ``step1_gap`` / ``stepN_gap``: over the leaves (each block's W and
      H), the largest | ||T1 - T0|| - ||T1' - T0|| | after the first epoch
      (and after the last), over the larger of the reference leaf's norm
      and the median leaf's.  Leaves whose first reference gradient is
      under a thousandth of the median leaf's are left out;
    - ``change_gap``: the same gap for the whole change after the last
      epoch (the norm over all leaves);
    - ``early_diff``: after the first epoch, over the leaves solved before
      the first half-solve whose reference CG reached its cap, the largest
      ||T1 - T1'|| over the larger of the reference leaf's change norm
      and the median leaf's.  A capped solve stops on no rule and turns
      rounding into a different step, so the leaves after it differ by
      more than rounding on any two sound sides; the leaves before it hold
      each product's rounding, which the norm of their change averages
      away.

    A cell compares the numbers its limits file names.

    Returns (numbers, the reference's tables per epoch); ``detail``, a
    list, receives each epoch's losses and leaf norms."""
    t0 = ref.cast(init)
    if ref_tables is None:
        ref_tables, cur = [], t0
        for _ in outputs:
            cur, its = ref.epoch(cur)
            ref_tables.append(cur)
            ref.iters.append(its)
    grads = ref.first_grad
    med_g = float(np.median(list(grads.values())))
    leaves = [key for key, g in grads.items() if g >= 1e-3 * med_g]

    def change(tables, e):
        return {(f, n): float(torch.linalg.vector_norm(
            tables[f][n] - t0[f][n])) for f, n in leaves}

    def leaf_gap(prog, refd):
        med = float(np.median(list(refd.values())))
        return max(abs(prog[x] - refd[x]) / max(refd[x], med, 1e-300)
                   for x in leaves)

    order = [(b.f12, key) for b in ref.blocks for key in ("W", "H")]
    capped = [i for i, it in enumerate(ref.iters[0]) if it >= ref.cap]
    early = [x for x in order[: capped[0] if capped else len(order)]
             if x in leaves]
    early_diff = float("nan")
    loss_gap, gaps, whole = 0.0, [], 0.0
    for e, out in enumerate(outputs):
        mine = ref.cast(out)
        lr = ref.objective(ref_tables[e])
        lp = ref.objective(mine)
        loss_gap = max(loss_gap, abs(lp - lr) / abs(lr))
        cp, cr = change(mine, e), change(ref_tables[e], e)
        gaps.append(leaf_gap(cp, cr))
        med = float(np.median(list(cr.values())))
        diff = {(f, n): float(torch.linalg.vector_norm(
            mine[f][n] - ref_tables[e][f][n])) / max(cr[(f, n)], med)
            for f, n in leaves}
        if e == 0 and early:
            early_diff = max(diff[x] for x in early)
        whole = abs(math.sqrt(sum(v * v for v in cp.values()))
                    - math.sqrt(sum(v * v for v in cr.values()))) \
            / math.sqrt(sum(v * v for v in cr.values()))
        if detail is not None:
            detail.append(dict(epoch=e + 1, loss=(lp, lr), leaves={
                f"{f}{n}": (cp[(f, n)], cr[(f, n)]) for f, n in leaves},
                diff={f"{f}{n}": v for (f, n), v in diff.items()}))
        del mine
    return dict(loss_gap=loss_gap, change_gap=whole, step1_gap=gaps[0],
                stepN_gap=gaps[-1], early_diff=early_diff), ref_tables


def repeat_gap(a: dict, b: dict) -> float:
    """The largest |a - b| over every leaf of two sets of host tables."""
    return max(float((a[f][n] - b[f][n]).abs().max()) for f in a
               for n in a[f])


def run(ctx: Context) -> DriverResult:
    from one_class_ffm_torch.train import Trainer, TrainConfig

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    epochs = int(traffic["epochs_per_job"])
    steps = int(traffic["check_steps"])
    problem = gen.make_problem(cfg, traffic, ctx.seed)
    prog_problem = ctx.hooks.get("program_problem", lambda p: p)(problem)
    data = program_input(prog_problem, cfg)
    tcfg = TrainConfig(item_path="", train_path="", k=int(cfg["k"]),
                       lam=float(cfg["lam"]), omega=float(cfg["omega"]),
                       r=float(cfg["r"]), nr_pass=epochs,
                       self_side=bool(cfg["self_side"]), seed=ctx.seed,
                       dtype=cfg["dtype"], blocked_bm=int(cfg["blocked_bm"]),
                       row_multiple=int(cfg["blocked_bm"]))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t_build = time.perf_counter()
    trainer = Trainer(tcfg, data=data, device=dev,
                      head_chunk=int(cfg["head_chunk"]))
    sync()
    build_s = time.perf_counter() - t_build
    solver = trainer.solver
    ctx.hooks.get("solver", lambda s: None)(solver)
    dims = table_dims(problem.users.dims, problem.items.dims,
                      bool(cfg["self_side"]))
    init = start_tables(problem, bool(cfg["self_side"]), int(cfg["k"]),
                        gen.STRUCTURE_SEED, dev)

    # set-up: the first job, the tables of its first epochs and its last
    # kept
    state = solver.refresh_caches({"params": init})
    outputs = []
    for e in range(epochs):
        state, _ = solver.epoch_stats(state)
        if e < steps:
            outputs.append(host_tables(state["params"], dims))
    first_job = host_tables(state["params"], dims)
    sync()
    del state
    outputs = ctx.hooks.get("outputs", lambda o, p, i: o)(outputs, problem,
                                                          init)
    meta = solver.meta
    layout_info = dict(
        u_head_rows=int(solver.data["blk_u_hd_rows"].shape[0])
        if solver.hd_u else 0,
        v_head_rows=int(solver.data["blk_v_hd_rows"].shape[0])
        if solver.hd_v else 0,
        u_head_chunks=int(solver.data["blk_u_hd_row"].shape[0])
        if solver.hd_u else 0,
        v_head_chunks=int(solver.data["blk_v_hd_row"].shape[0])
        if solver.hd_v else 0,
        blocked_bm_u=meta.blocked_bm_u, blocked_bm_v=meta.blocked_bm_v,
        fused_u=list(meta.fused_u), fused_v=list(meta.fused_v))

    # the window: whole jobs until --seconds have passed
    iters: List[List[int]] = []
    jobs = 0
    digest = None
    prof = trace.profiler() if ctx.traced else None
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    while True:
        if prof is not None and jobs == 0:
            prof.__enter__()
            t_job = time.perf_counter()
        with ctx.spans.span("restore"):
            state = solver.refresh_caches({"params": init})
        for _ in range(epochs):
            with ctx.spans.span("epoch"):
                state, it = solver.epoch_stats(state)
            iters.append([int(x) for x in it.tolist()])
        sync()
        jobs += 1
        if prof is not None and jobs == 1:
            t_traced = time.perf_counter() - t_job
            prof.__exit__(None, None, None)
            digest = trace.digest(prof)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    repeat = repeat_gap(host_tables(state["params"], dims), first_job)
    del state, first_job
    users = problem.users.rows
    run_info = dict(
        epochs=len(iters), jobs=jobs, window_s=window_s,
        cg_iters=iters, build_s=build_s, layout=layout_info, digest=digest)
    if digest is not None:
        # the required work of the traced job, at the card's peaks
        c = work.Counter(work.load_peaks(torch.cuda.get_device_name(dev)))
        shape = work.shape_of(cfg, problem.pos_u.shape[0])
        work.restore_work(shape, c)
        for it in iters[:epochs]:
            work.epoch_work(shape, it, c)
        run_info.update(bound_s=c.seconds, traced_wall_s=t_traced)

    # the comparison, with the program freed
    del solver, trainer, data, init
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(problem, hyper(cfg), dev, torch.float64)
    nums, _ = compare(ref, start_tables(problem, bool(cfg["self_side"]),
                                        int(cfg["k"]), gen.STRUCTURE_SEED,
                                        dev),
                      outputs, detail=ctx.hooks.get("detail"))
    nums["repeat_gap"] = repeat
    checks = [Check(name, float(nums[name]), float(limit))
              for name, limit in ctx.limits.items()]
    run_info.update(numbers=nums, reference_cg_iters=ref.iters)
    print(f"layout {layout_info}", file=sys.stderr, flush=True)
    return DriverResult(
        end_to_end=dict(train_examples_per_s=users * len(iters) / window_s,
                        setup_s=setup_s),
        checks=checks, attempted=jobs, failed=0, memory_peak_bytes=peak,
        run=run_info)
