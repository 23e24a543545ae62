#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check every part of it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a, one
   compiler per source, in parallel) and print each kernel's registers per
   thread and static shared memory (cuobjdump), which set how many CTAs an
   SM holds;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the arguments its first call receives in a real half-solve, at float32
   and bfloat16: bit-identical on repeat, max-rel within the bound (1e-5 /
   5e-3; the plain versions add in the kernels' order, so they agree bit
   for bit), with kernel, plain and library times (CUDA events, float32;
   for the table passes also their X^T stage alone) and the bound of the
   work (bytes over 3.35 TB/s or operations over 67 TFLOP/s f32, whichever
   is larger, counted from the inputs): the three
   blocked kernels in MF solves (200k users x 20k items, k=32, both solve
   sides); the four fused table kernels and the projection B8 in FFM solves
   (the same rows, u-side field D=1000 and v-side field D=500); the blocked
   kernels, B8 and the general scatter (through X, and untimed through
   X^2) in FM solves (one flattened field per side, D=201,000 and 20,500);
   Then the Jacobi variants of three of them (the second output of B2, B5
   and B7) on arguments recorded from real Jacobi half-solves of the FFM,
   and B9 and B10 on the MF streams, each also against B1's output; then
   B1-B7 on the skewed FFM's streams (bench.py's BENCH_SKEW=1 problem:
   item popularity zipf 1.0, whose v side takes the two-tier layout: its
   tail, where the power items own no slots), timed apart from the rest;
   then the COO passes (``pos_scatter``, ``pos_scatter_pair``,
   ``pos_seg_sum``, the fused Hv ``pos_hv_coo``: one kernel over a side's
   list of the positive stream) and ``pos_dot`` (the step's gaps over the
   stream) on the FFM with both sides COO (``blocked_bm=0``, both sides)
   and on the skewed FFM without the head tier under Jacobi (its v side
   COO), with ``Tensor.index_add_`` as the list passes' library yardstick
   (none for the fused Hv and ``pos_dot``: the Hv's line gives its two-call
   form's time instead), timed at float32 and bfloat16; then the CG
   recurrence (``cg_init``, ``cg_step``: csrc/cg_ops.cu) on the G, D and
   first Hv of the MF solves (200,000 x 32 and 20,000 x 32 vectors, timed,
   with the eager torch sequence it replaced beside it) and of the FFM's
   categorical cross solves under Jacobi (compared only), the vectors and
   scalars bit for bit after the start and after a step, f32 and bf16;
   then each row's top K (``topk_rows``: csrc/topk_ops.cu) at the rank
   cell's shape, 1,024 x 359,966 scores, K = 10 and 80, float32 and
   bfloat16, ids and value bits against the stable descending sort, with
   ``torch.topk`` as the library yardstick.
   Before them, ``[data]`` lines give the static plans the redesigned
   kernels read: each stream side's row runs (mean and longest), each COO
   side's list of the stream and each feature-major list's single-chunk,
   multi-chunk and featureless features;
4. reference: on a small MF problem, a small FFM problem with self blocks
   and a small FM problem whose fields are above a lowered fused-table cap,
   the gradients and Hv products the kernels give on the card match the
   fp64 numpy oracle, and the objective the solver tracks through two
   kernel-driven epochs matches the oracle's brute-force loss; the same on
   a small skewed FFM (power rows on both sides, the head tier on both);
   a small FFM with both sides COO and a small skewed FFM with its v side
   COO and its u side blocked; the FFM, FM, skewed and COO problems again
   under Jacobi, with the Hessian diagonal against the oracle's and two
   epochs against the oracle's Jacobi epochs;
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
   FFM and FM again under Jacobi-preconditioned CG: the three diagonal
   variants must have launched, and the CG counts print beside plain CG's;
   then the skewed FFM at the same sizes (the head tier on its v side):
   B1-B8 must have launched, one epoch run twice from one state must give
   the same bits, and each head op's per-call time on its v side is
   printed; then the FFM with both sides COO (``blocked_bm=0``, plain CG:
   ``pos_scatter``, ``pos_seg_sum``, ``pos_hv_coo``, ``pos_dot``, B8 and
   the general scatter must have launched, no blocked or fused kernel) and
   the skewed FFM with ``head_chunk=0`` under Jacobi (v COO: the pair, the
   width-1 sums, the fused Hv and ``pos_dot``; u blocked: its blocked and
   fused Jacobi kernels), each also run twice from one state.  Every main
   path refreshes its residual through ``pos_dot`` (the FFM's must have
   launched it), and runs its CG as CUDA graph replays of the recurrence
   kernel with each Hv (``cg_init`` and ``cg_step`` must have launched;
   each replay counts the launches it recorded); after each, one epoch
   from the same state on that device loop and on the host loop (one
   eager iteration per host test) must give the same bits and CG counts,
   with each loop's host reads, the replays and the masked iterations'
   device time printed;
8. serving: the headline FFM of phase 6 saved as a text model and a
   checkpoint, its items' and its 111,963 test users' feature rows written
   to files; ``predict_topk_from_model`` ranks every test user over the
   full 20,000-item catalog, top 10, from the checkpoint (B8 and
   ``topk_rows`` must have launched), with the ids of the same call on
   ``project_plain`` (identical), of ``Trainer.predict_topk`` (at least
   0.99 shared) and of
   the text model (printed); users/s over its device work, best of 3,
   split into projection, scoring and ranking; then the scoring entry
   point (``one_class_ffm_torch.entry``) on the card and ``serve_bench``
   at its defaults with its ``torch.topk`` yardstick;
9. the Hv variants' path: ``hv_pack_bench`` checks B1, B9 and B10 on its
   synthetic stream and times them; B9 and B10 must have launched;
10. the meshes (``torch.distributed``, gloo: the ranks share the one
   card, each in its own spawned process; NCCL would need a card per
   rank): ``[mesh ffm]``, the headline FFM at full width on a 2-rank data
   mesh; ``[mesh ffm-skew]``, the skewed FFM of phase 3 (its arrays
   padded and shard-aligned, ``reshard``) with the head tier under 2
   ranks; ``[mesh ffm-coo]``, the headline FFM with both sides COO
   (``blocked_bm=0``) on 2 ranks; ``[mesh ffm-2d]``, the headline FFM on
   the 2x2 data x model mesh (4 ranks, the id tables row-sharded on the
   model axis); 2 epochs each.  Each: each rank's half-solves of the
   cross and self block kinds (on the skewed and COO paths the cross
   blocks' v halves too) from the one-process state after one epoch
   against the one-process path (gradient and Hv within 1e-5 of the
   largest value, the step within 1e-4 at the same CG count), the epochs
   from the seed's tables through the Trainer
   (objective within 1e-3 of the one-process run's, CG counts printed
   beside it, epoch seconds not a scaling number), validation sharded by
   users and by items, the item-sharded top 10 equal to the top 10 of
   the ranks' gathered scores, the collective census of each epoch
   (inside CG one all-reduce per Hv, never an all-gather), each rank's
   kernels held against their plain versions on its own inputs and
   launched on each rank; rank 0 of ``[mesh ffm]`` and of ``[mesh
   ffm-2d]`` writes the text model after the epochs: the 2x2 mesh's file
   equal to the 2-rank data mesh's (true dims, every value: the model
   axis only gathers exact copies), each within ``MESH_FILE_TOL`` of the
   one process's;
11. entry points (from phase 10 on, a failed phase is reported and the
   next one runs; the run fails at the end): ``python -m one_class_ffm_torch`` on small text
   datasets, MF with --ns, FFM without, FM with its user field above the
   cap, and MF with --ns --blocked-bm 0, must exit 0;
   ``python -m one_class_ffm_torch.predict --scores`` on the FFM run's text
   model and checkpoint must exit 0 and print the in-process call's lines;
   MF with --ns under ``--profile-dir`` must exit 0 and leave a trace with
   CUDA kernel events;
12. ``[prep]``: the port's KKBox pipeline on tiny raw CSVs, then one epoch
   on the card on its output (finite metrics); ``[bf16 mf]``: MF --ns at
   full width, 11 epochs at bf16 and at float32, the AUC of each epoch
   side by side (finite).

``python3 chip_smoke.py cg-bench ROOT [ROOT ...]`` trains MF, the FFM,
the skewed FFM and the both-COO FFM in each tree in turn (3 epochs, peak
memory, host reads of the CG stop test, a profiled epoch);
``groups:ROOT`` at each CG group size.  ``python3 chip_smoke.py cg-kernels
ROOT [ROOT ...]`` times each tree's recurrence kernels (``cg_init``,
``cg_step``) at the MF solves' shapes, f32 and bf16, plain CG and Jacobi.
``python3 chip_smoke.py topk-kernels`` runs phase 3's ``topk_rows`` lines
alone, then ``topk_rows`` at 1 to 1,024 rows against one segment a row.

The line before the last is a JSON object with one entry per kernel: its
launches summed over the eight main paths, the serving path and the mesh
paths' ranks (B9 and B10: over the bench's run), its largest error against
the plain version,
and its times and bound summed over the sides and shapes of phase 3 but
the skewed FFM's.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the one_class_ffm_torch package beside this file, it exits 1
and prints no result.  Nothing here imports jax or the JAX
package.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

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
    # the same TPU kernels' Jacobi outputs (w_blk / w_blk / dd)
    "pos_scatter_blocked_diag": f"{_JAX_OPS}:1623",
    "grad_cross_tbl_diag": f"{_JAX_OPS}:1695",
    "grad_self_tbl_diag": f"{_JAX_OPS}:1900",
    "pos_hv_packed": "scripts/hv_pack_bench.py:84",
    "pos_hv_blocked_g": "scripts/hv_pack_bench.py:150",
    # the positive passes of a COO side (XLA ops there, ported as one
    # kernel over the side's list for determinism): pos_scatter,
    # pos_scatter_pair, the self blocks' segment_sum of the stream's
    # coefficients and the two-call Hv (pos_dot, then pos_scatter of
    # (1 - omega) pq); the stream's gather-and-dot pos_dot
    "pos_scatter": f"{_JAX_OPS}:230",
    "pos_scatter_pair": f"{_JAX_OPS}:264",
    "pos_seg_sum": "one_class_ffm_tpu/solver/jax_solver.py:1215",
    "pos_hv_coo": "one_class_ffm_tpu/solver/jax_solver.py:1900",
    "pos_dot": f"{_JAX_OPS}:215",
    # the CG recurrence of a Newton solve: the while_loop's start (S0, V0,
    # g2, rz0) and its body with the cond (XLA ops inside the jitted
    # epoch there)
    "cg_init": "one_class_ffm_tpu/solver/jax_solver.py:2044",
    "cg_step": "one_class_ffm_tpu/solver/jax_solver.py:2018",
    # each row's top K of the scores (jax.lax.top_k in ranking)
    "topk_rows": "one_class_ffm_tpu/predict.py:114",
}
BLOCKED = ("pos_hv_blocked", "pos_scatter_blocked", "pos_gap_blocked")
TABLE = ("pos_hv_tbl", "grad_cross_tbl", "hv_self_tbl", "grad_self_tbl")
WIDE = ("project", "scatter")
DIAG = ("pos_scatter_blocked_diag", "grad_cross_tbl_diag",
        "grad_self_tbl_diag")
VARIANTS = ("pos_hv_packed", "pos_hv_blocked_g")
COO = ("pos_scatter", "pos_scatter_pair", "pos_seg_sum", "pos_hv_coo")
DOT = ("pos_dot",)
CG = ("cg_init", "cg_step")
TOPK = ("topk_rows",)
_CSRC = "one_class_ffm_torch/csrc/"
# (B5's row stage runs on B2's body in blocked_ops.cu, its X^T stage in
# table_ops.cu)
SOURCE = {name: _CSRC + (
    "blocked_ops.cu" if name in BLOCKED + ("pos_scatter_blocked_diag",
                                           "grad_cross_tbl",
                                           "grad_cross_tbl_diag")
    else "project_ops.cu" if name == "project"
    else "hv_variants.cu" if name in VARIANTS
    else "coo_ops.cu" if name in COO + DOT
    else "cg_ops.cu" if name in CG
    else "topk_ops.cu" if name in TOPK
    else "table_ops.cu") for name in REPLACES}
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


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
               va_frac: float = 0.2, pop_skew: float = 0.0,
               power: int = 0, shards: int = 1):
    """LoadedData from ``generate_vectorized``: one identity id field per
    side (MF) unless ``dims_u``/``dims_v`` name more fields, flattened into
    one field per side when ``fm``, with a fraction of each user's
    positives held out for validation as ``write_dataset`` does (users keep
    >= 1 training positive; users with no held-out label are not test
    users; test users keep their feature rows).  ``pop_skew`` > 0: item
    popularity ~ rank^-pop_skew, from ``build_padded`` (the stream bench.py
    draws with BENCH_SKEW; ``generate_vectorized`` ignores pop_skew).
    ``power`` > 0: the first ``power`` items are training positives of
    every user and the first ``power`` users like every item (power rows
    on both sides).  ``shards`` > 1: the stream shard-aligned for a data
    mesh of that many ranks (``pad_labels(shard_rows=)``)."""
    import numpy as np

    from one_class_ffm_torch.data.dataset import (
        Interactions,
        PaddedFields,
        pad_labels,
    )
    from one_class_ffm_torch.data.synth import (
        SynthSpec,
        build_padded,
        generate_vectorized,
    )
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.train import LoadedData

    spec = SynthSpec(n_users=n_users, n_items=n_items,
                     fu=len(dims_u) if dims_u else 1,
                     fv=len(dims_v) if dims_v else 1,
                     dims_u=dims_u, dims_v=dims_v, avg_pos=avg_pos, seed=seed,
                     pop_skew=pop_skew)
    make = build_padded if pop_skew > 0 else generate_vectorized
    (du, dv), u_pad, v_pad, y_all = make(spec, np.float32,
                                         row_multiple=row_multiple)
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

    ut, vt = u[~is_va], v[~is_va]
    if power:  # (user, item) pairs as keys; held-out pairs stay out
        grid = np.arange(power)
        key = np.union1d(
            ut * n_items + vt,
            np.concatenate([np.arange(n_users)[:, None] * n_items + grid,
                            grid[:, None] * n_items + np.arange(n_items)],
                           axis=None))
        key = key[~np.isin(key, u[is_va] * n_items + v[is_va])]
        ut, vt = key // n_items, key % n_items
    tr = np.lexsort((vt, ut))
    ut, vt = ut[tr], vt[tr]
    indptr = np.zeros(n_users + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(ut, minlength=n_users))
    y_pad = pad_labels(Interactions(m=n_users, n=n_items, indptr=indptr,
                                    col=vt),
                       u_pad.m, v_pad.m, nnz_multiple=row_multiple * 8,
                       dtype=np.float32,
                       shard_rows=u_pad.m // shards if shards > 1 else 0)
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
                 epochs: int = 3, cg_precond: str = "auto",
                 blocked_bm: int = 256, head_chunk: int = 512, seed: int = 0,
                 **cfg_kw):
    from one_class_ffm_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(item_path="<memory>", train_path="<memory>", k=k,
                      lam=0.05, omega=0.1, r=-1.0, nr_pass=epochs,
                      self_side=data.layout.self_side, dtype=dtype,
                      eval_every=epochs, seed=seed, cg_precond=cg_precond,
                      blocked_bm=blocked_bm, **cfg_kw)
    return Trainer(cfg, data=data, device=device, head_chunk=head_chunk)


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


def print_static_plan(tag: str, data) -> None:
    """The static structures the redesigned kernels read, per solver: each
    stream side's row runs (the span per CTA of B1, B2 and B4 and their
    longest dependent chain, the longest run) and each feature-major list's split into
    single-chunk features (written by the X^T stage's first pass), features
    with several chunks and features with none (both by its second).  On a
    two-tier side the stream is the tail; its head tier's rows and chunks
    follow.  A COO side prints its list of the stream instead: its rows
    with one chunk, with several, with none, and the longest row."""
    for side in ("u", "v"):
        coo = data.get("coo_" + side)
        if coo is not None:
            nch = coo.feat_ptr[1:] - coo.feat_ptr[:-1]
            per_row = (coo.chunk_ptr[coo.feat_ptr[1:].long()]
                       - coo.chunk_ptr[coo.feat_ptr[:-1].long()])
            print(f"[data] {tag} COO side {side}: list of the stream, "
                  f"{coo.row.numel()} entries in {nch.sum().item()} chunks "
                  f"over {nch.numel()} rows: single-chunk rows "
                  f"{int((nch == 1).sum())}, multi-chunk "
                  f"{int((nch > 1).sum())} (their chunks "
                  f"{int(nch[nch > 1].sum())}), empty "
                  f"{int((nch == 0).sum())}, longest row "
                  f"{int(per_row.max())} entries")
        else:
            print_stream_plan(tag, side, data)
        for fi, xt in enumerate(data[f"xf_{side}"]):
            if xt is None:
                continue
            nch = (xt.feat_ptr[1:] - xt.feat_ptr[:-1])
            print(f"[data] {tag} {side} field {fi}: D={nch.numel()} "
                  f"chunks={xt.chunk_dst.numel()}: single-chunk features "
                  f"{int((nch == 1).sum())}, multi-chunk "
                  f"{int((nch > 1).sum())} (their chunks "
                  f"{int(nch[nch > 1].sum())}), featureless "
                  f"{int((nch == 0).sum())}")


def print_stream_plan(tag: str, side: str, data) -> None:
    """A blocked side's row runs, and its head tier's rows and chunks."""
    runs = data[f"blk_{side}_runs"]
    length = (runs[:, 1:] - runs[:, :-1]).float()
    print(f"[data] {tag} stream {side}: {runs.shape[0]} blocks x MAXC "
          f"{data[f'blk_{side}_own'].shape[1]}, "
          f"{int(runs[:, -1].sum())} valid slots, row runs mean "
          f"{length.mean().item():.2f} longest {int(length.max())} slots")
    if f"blk_{side}_hd_take" in data:
        nch, chunk = data[f"blk_{side}_hd_take"].shape
        tab = data[f"blk_{side}_hd_tab"]
        per_row = (tab < nch).sum(dim=1)
        print(f"[data] {tag} head tier {side}: "
              f"{data[f'blk_{side}_hd_rows'].numel()} head rows, {nch} "
              f"chunks x {chunk} "
              f"({int((data[f'blk_{side}_hd_w'] != 0).sum())} valid "
              f"slots), chunks per row mean "
              f"{per_row.float().mean().item():.2f} most "
              f"{int(per_row.max())}")


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


def _nbytes(a, squared: bool = False) -> int:
    """Bytes of a tensor, of a tuple of outputs, or of a feature-major list
    (with its squared values when the function reads them)."""
    import torch

    from one_class_ffm_torch.ops.layout import FeatureMajor

    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, tuple) and not isinstance(a, FeatureMajor):
        return sum(_nbytes(t) for t in a)
    if isinstance(a, FeatureMajor):  # a list of the stream: pos, no val
        return sum(_nbytes(t) for t in (a.row, a.val, a.chunk_ptr,
                                        a.feat_ptr, a.combine, a.chunk_dst,
                                        a.slot_feat, a.pos)) + (
            _nbytes(a.val_sq) if squared else 0)
    return 0


# the position of ``own`` among the arguments of each kernel that reads its
# rows' runs in place of the owners when it is given them
OWN_ARG = {"pos_hv_blocked": 2, "pos_scatter_blocked": 2,
           "pos_scatter_blocked_diag": 2, "pos_hv_tbl": 5,
           "pos_gap_blocked": 2, "grad_self_tbl": 3, "grad_self_tbl_diag": 3,
           "grad_cross_tbl": 2, "grad_cross_tbl_diag": 2,
           "pos_hv_blocked_g": 2, "pos_hv_packed": 2}


def work(name: str, args, out, kw=None):
    """(bytes, operations) that the function needs on these inputs: each
    input read once and the output written once (for ``project`` only the
    table rows its ids name; for B9 one lane of each 32-lane group of the
    packed weights, and of the owners unless it is given its rows' runs;
    for B1-B5, B7, B9 and B10 given their rows' runs, the runs in place of
    the owners), and the products and sums of the
    entries these inputs hold (valid slots, nonzero X entries), not of
    padding.  A Jacobi variant adds its second payload (rows^2 scaled and
    summed per slot, or dd Q1 Q1 per row) and its X^2 pass.  A COO pass
    and ``pos_dot``: ``coo_work``.  ``topk_rows``: the scores read once,
    the values and int64 ids written once, a comparison an element."""
    import torch

    if name in COO + DOT:
        return coo_work(name, args, out)
    if name == "topk_rows":
        z, k = args
        return (z.numel() * z.element_size()
                + z.shape[0] * min(k, z.shape[1]) * 12, z.numel())
    diag = name.endswith("_diag")
    nbytes = (sum(_nbytes(a, squared=diag) for a in args) + _nbytes(out))
    runs = (kw or {}).get("runs")
    if runs is not None:  # the kernel reads the runs, not the owners
        nbytes += _nbytes(runs) - _nbytes(args[OWN_ARG[name]])
    if name == "pos_hv_packed":
        phi, rows_p, own_p, w_p, dense, num_out, bm = args[:7]
        nbytes -= _nbytes(w_p) * 31 // 32
        if runs is None:
            nbytes -= _nbytes(own_p) * 31 // 32
        k = phi.shape[1]
        live = int((own_p[:, :, ::k] < bm).sum())
        return nbytes, live * (4 * k + 2) + num_out * 2 * k * k
    if name == "pos_hv_blocked_g":
        name = "pos_hv_blocked"
    if name == "pos_scatter_blocked_diag":
        _, rows, own, _, bm = args[:5]
        k = rows.shape[2]
        return nbytes, int((own < bm).sum()) * (5 * k + 1)
    if diag:
        k = out[0].shape[1]
        xt = next(a for a in args if hasattr(a, "feat_ptr"))
        xt_ops = 4 * k * xt.row.numel()
        if name == "grad_cross_tbl_diag":
            _, rows, own, _, dense, bm = args[:6]
            return nbytes, (int((own < bm).sum()) * (5 * k + 1)
                            + dense.numel() + xt_ops)
        _, Q1, _, own, _, bm = args[:6]  # grad_self_tbl_diag
        return nbytes, (int((own < bm).sum()) + Q1.shape[0] * (3 * k + 1)
                        + xt_ops)
    if name == "project":
        idx, val, W = args
        live = val != 0
        used = torch.unique(idx[live]).numel()
        nbytes += used * W.shape[1] * W.element_size() - _nbytes(W)
        return nbytes, 2 * W.shape[1] * int(live.sum())
    if name == "scatter":
        xt, Z = args[:2]
        if args[2:] and args[2]:  # through X^2: val_sq is read, not val
            nbytes += _nbytes(xt.val_sq) - _nbytes(xt.val)
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


def _named_rows(T, ids) -> int:
    """Bytes of the rows of ``T`` that ``ids`` name (ids clamped into
    range, as the kernels clamp them)."""
    import torch

    used = torch.unique(ids.long().clamp(0, T.shape[0] - 1)).numel()
    return used * T.shape[1] * T.element_size()


def coo_work(name: str, args, out):
    """(bytes, operations) of a COO pass or ``pos_dot`` on these inputs:
    each array it reads once (of its list the entries' arrays it reads, the
    chunk arrays and plan; the coefficients whole; of the gathered table,
    and of ``pos_dot``'s two, the rows the ids name) and its output once;
    per entry the products and sums (a k-long dot 2k, a scaled row and its
    add 2k, the pair's second payload 3k more)."""
    if name == "pos_dot":
        A, u, B, v = args[:4]
        return (_nbytes(u) + _nbytes(v) + _nbytes(out) + _named_rows(A, u)
                + _named_rows(B, v)), 2 * A.shape[1] * u.numel()
    coo = next(a for a in args if hasattr(a, "feat_ptr"))
    nnz = coo.row.numel()
    plan = sum(_nbytes(t) for t in (coo.chunk_ptr, coo.feat_ptr,
                                    coo.combine, coo.chunk_dst,
                                    coo.slot_feat))
    if name == "pos_seg_sum":
        c = args[0]
        return plan + _nbytes(coo.pos) + _nbytes(c) + _nbytes(out), nnz
    B = args[1]
    k = B.shape[1]
    nbytes = plan + _nbytes(coo.row) + _named_rows(B, coo.row) + _nbytes(out)
    if name == "pos_hv_coo":  # phi, the weights; chunk rows
        phi = args[0]
        nbytes += _nbytes(phi) + _nbytes(coo.val) + (coo.chunk_ptr.numel()
                                                     - 1) * 4
        return nbytes, (4 * k + 2) * nnz
    c = args[0]
    nbytes += _nbytes(coo.pos) + _nbytes(c)
    if name == "pos_scatter_pair":
        return nbytes + _nbytes(coo.val), 5 * k * nnz
    return nbytes, 2 * k * nnz


def sector_floor_bytes(args, nbytes: int) -> int:
    """B9's bytes (``work``) with each slot's weight counted as the 32-byte
    sector that holds it, not as the weight alone: the packed weights of two
    slots sit 32 lanes apart, never in one sector, so the card reads at
    least that much.  The bound does not count it; its [kernels] line
    prints both."""
    w_p = args[3]
    n_slots = w_p.shape[0] * w_p.shape[1] * 4
    return nbytes + n_slots * (32 - w_p.element_size())


def bound_of(nbytes: float, ops: float):
    """(least time in ms, what binds it) on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(name: str, args):
    """One PyTorch call that computes the same function on the same inputs,
    where there is one, as a yardstick (the port never calls it): a
    weighted sum of embedding rows for B8, a sparse product for the
    blocked gradient scatter and the general scatter, ``Tensor.index_add_``
    of the scaled gathered rows (float atomics: not deterministic) for the
    COO passes, cuSPARSE's sampled product (SDDMM) for ``pos_dot``,
    ``torch.topk`` (no order among equal values) for ``topk_rows``.  Index
    conversion and the sparse matrix's structure are built here, outside
    the timing; returns the call or None."""
    import warnings

    import torch

    if name == "pos_hv_coo":  # no one call computes it
        return None
    if name == "topk_rows":
        z, k = args
        return lambda: torch.topk(z, k)
    if name in COO:
        coo = next(a for a in args if hasattr(a, "feat_ptr"))
        d = coo.feat_ptr.numel() - 1
        per_row = (coo.chunk_ptr.long()[coo.feat_ptr.long()[1:]]
                   - coo.chunk_ptr.long()[coo.feat_ptr.long()[:-1]])
        seg = torch.repeat_interleave(
            torch.arange(d, device=per_row.device), per_row)
        pos, take = coo.pos.long(), coo.row.long()
        if name == "pos_seg_sum":
            c = args[0]
            return lambda: c.new_zeros(d).index_add_(0, seg, c[pos])
        c, B = args[0], args[1]
        k = B.shape[1]
        if name == "pos_scatter":
            return lambda: B.new_zeros((d, k)).index_add_(
                0, seg, c[pos][:, None] * B[take])
        from one_class_ffm_torch.ops.sparse_ops import storage_scale

        wq = storage_scale(coo.val, args[3])  # list order

        def pair():
            rows = B[take]  # one gather for both payloads
            return (B.new_zeros((d, k)).index_add_(0, seg,
                                                   c[pos][:, None] * rows),
                    B.new_zeros((d, k)).index_add_(
                        0, seg, (wq[:, None] * rows) * rows))
        return pair

    # the sparse tensors' constructors warn that CSR support is in beta
    warnings.filterwarnings("ignore", message="Sparse")
    if name == "pos_dot":
        # out = (A @ B^T) at the stream's pairs, a CSR pattern of the
        # stream's real entries (the pads' ghost ids, past the tables,
        # dropped), its columns sorted within a row; float32 only
        A, u, B, v = args[:4]
        if A.dtype != torch.float32:
            return None
        na, nb = A.shape[0], B.shape[0]
        keep = (u >= 0) & (u < na) & (v >= 0) & (v < nb)
        key = torch.sort(u[keep].long() * nb + v[keep].long()).values
        crow = torch.searchsorted(key, torch.arange(
            na + 1, device=key.device) * nb)
        S = torch.sparse_csr_tensor(crow, key % nb,
                                    torch.ones_like(key, dtype=A.dtype),
                                    size=(na, nb))
        Bt = B.t()
        return lambda: torch.sparse.sampled_addmm(S, A, Bt, beta=0.0)
    if name == "project":
        idx, val, W = args
        idx_l = idx.long()
        return lambda: torch.nn.functional.embedding_bag(
            idx_l, W, mode="sum", per_sample_weights=val)
    if name == "scatter":
        xt, Z = args[:2]
        d = xt.feat_ptr.numel() - 1
        Xt = torch.sparse_csr_tensor(
            xt.chunk_ptr.long()[xt.feat_ptr.long()], xt.row.long(),
            xt.val_sq if args[2:] and args[2] else xt.val,
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


_REGS: dict = {}  # kernel_registers of this process's library, once read


def kernel_registers(lib_path: str):
    """{(kernel, dtype, Jacobi variant?, integer template arguments):
    (registers per thread, bytes of static shared memory, bytes of stack
    per thread)} of the built library, from ``cuobjdump -res-usage`` of the
    CUDA toolkit, or None where it is missing: with 256 threads per CTA the
    register count sets how many CTAs an SM holds, which the latency-bound
    stream kernels need, and a stack frame holds what spilled past them.
    The integer arguments are a width plan's (G, NV, VE) (common.cuh
    by_width); a kernel without a storage type (the X^T stage's combine
    pass) sums f32 partials."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-res-usage", lib_path], capture_output=True,
                         text=True, timeout=120).stdout
    regs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"\d+([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f)?"
                      r"((?:Li\d+E|Lb[01]E?)*)", line)
        if m and (m.group(2) or m.group(3)):
            targs = m.group(3)
            name = (m.group(1), "bf16" if m.group(2) == "13__nv_bfloat16"
                    else "f32", "Lb1" in targs,
                    tuple(int(x) for x in re.findall(r"Li(\d+)E", targs)))
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            shared = re.search(r"SHARED:(\d+)", line)
            stack = re.search(r"STACK:(\d+)", line)
            regs[name] = (int(m.group(1)),
                          int(shared.group(1)) if shared else 0,
                          int(stack.group(1)) if stack else 0)
            name = None
    return regs


def time_ms(fn, reps: int = 10, rounds: int = 5,
            warm_ms: float = 25.0) -> float:
    """Median over rounds of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after ``warm_ms`` of warm-up calls (at least two): the
    card idles at a low clock (345 MHz at the start of a run) and reaches
    its boost clock only after milliseconds of work, so a short function
    timed right after a pause would be timed at the low clock."""
    import torch

    t0 = time.perf_counter()
    for i in range(1 << 30):
        fn()
        torch.cuda.synchronize()
        if i >= 1 and (time.perf_counter() - t0) * 1e3 >= warm_ms:
            break
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


def device_ms(fn, reps: int = 20, events=()):
    """Mean device time per call of ``fn``: the summed durations of the
    device operations its ``reps`` calls run, by torch.profiler.  A call
    whose wrapper takes longer on the host than its kernel on the card is
    timed by ``time_ms`` at the host's launch rate; this is the card's own
    share.  ``events``: kernel names, and the launches per call of kernels
    so named are returned too, as (ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace without device events is the profiler's miss
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    ms = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / reps
    if not events:
        return ms
    return ms, sum(any(k in e.name for k in events) for e in dev) / reps


def new_report():
    return {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, nbytes=0,
                       ops=0, library_ms=None)
            for name in REPLACES}


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def compare(name: str, side: str, dt_name: str, args, kw, report, gpu: str,
            same_as=None, timed: bool = True):
    """One kernel against its plain version on the same inputs (a Jacobi
    variant: both outputs against the plain version called with the
    diagonal's argument): two launches bit-identical, max-rel within the
    bound; ``same_as``: a tensor the kernel must reproduce bit for bit (B1's
    output, for its variants).  At float32 (where ``timed``) also the
    kernel, plain and library times and the work's bound, which the report
    sums; a COO pass, ``pos_dot`` and ``topk_rows`` are timed at bfloat16
    too (printed, not summed), and the fused Hv beside its two-call form."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    kern = getattr(kernels, name)
    plain = getattr(ops, name.removesuffix("_diag") + "_plain")
    # B1's, B2's and B4's rows' runs are the kernels' encoding of ``own``:
    # the plain versions read ``own``
    pkw = {key: a for key, a in kw.items() if key != "runs"}
    got, got2 = kern(*args, **kw), kern(*args, **kw)
    ref = plain(*args, **pkw)
    _sync(ref.device if isinstance(ref, torch.Tensor) else ref[0].device)
    pairs = list(zip(_outputs(got), _outputs(got2), _outputs(ref)))
    check(len(pairs) == len(_outputs(ref)),
          f"{name} {side} {dt_name}: {len(_outputs(got))} outputs, plain "
          f"{len(_outputs(ref))}")
    err = rel = 0.0
    equal = True
    for g, g2, f in pairs:
        check(torch.equal(g, g2), f"{name} {side} {dt_name}: two launches "
                                  "differ")
        check(g.shape == f.shape and g.dtype == f.dtype,
              f"{name} {side} {dt_name}: {g.shape} {g.dtype} vs plain "
              f"{f.shape} {f.dtype}")
        e = (g.double() - f.double()).abs().max().item()
        scale = f.double().abs().max().item()
        err, rel = max(err, e), max(rel, e / scale if scale > 0 else e)
        equal = equal and torch.equal(g, f)
    r = report[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    line = (f"[kernels] {name:24s} {side} {dt_name:8s} max-rel {rel:.3e} "
            f"(bound {BOUND[dt_name]:g}) max-abs {err:.3e} bit-equal "
            f"{equal}")
    if same_as is not None:
        b1_equal = torch.equal(_outputs(got)[0], same_as)
        line += f" B1-bits {b1_equal}"
        check(b1_equal, f"{name} {side} {dt_name}: not B1's bits")
    if timed and (dt_name == "float32" or name in COO + DOT + TOPK):
        ms = time_ms(lambda: kern(*args, **kw))
        pms = time_ms(lambda: plain(*args, **pkw))
        nbytes, nops = work(name, args, got, kw)
        bms, by = bound_of(nbytes, nops)
        lib = library_call(name, args)
        lms = time_ms(lib) if lib is not None else None
        if dt_name == "float32":
            r["ms"] += ms
            r["plain_ms"] += pms
            r["nbytes"] += nbytes
            r["ops"] += nops
            if lms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + lms
        line += (f"  kernel {ms:.4f} ms  plain {pms:.4f} ms  library "
                 f"{'none' if lms is None else f'{lms:.4f} ms'}  bound "
                 f"{bms:.4f} ms by {by} ({nbytes} B, {nops} ops)")
        if name == "pos_hv_coo":
            line += f"  two-call form {time_ms(two_call_hv(*args)):.4f} ms"
        if name == "pos_hv_packed":
            fms, _ = bound_of(sector_floor_bytes(args, nbytes), nops)
            line += f"  sector floor {fms:.4f} ms"
        if name in XT_STAGED:  # a row stage, then X^T
            line += f"  X^T stage alone {xt_stage_ms(name, args):.4f} ms"
        line += f"  [{gpu}]"
    print(line)
    check(rel <= BOUND[dt_name],
          f"{name} {side} {dt_name}: max-rel {rel:.3e} > {BOUND[dt_name]:g}")


def two_call_hv(phi, B, coo, w_scale):
    """The fused Hv's function as the two calls it replaces, on this tree's
    kernels: ``pos_dot`` over the list's entries times their weights, the
    (1 - omega) scaling, then ``pos_scatter`` reading the coefficients in
    list order (the list's stream positions made the identity)."""
    import torch

    from one_class_ffm_torch.ops import sparse_ops as ops

    fptr = coo.feat_ptr.long()
    counts = coo.chunk_ptr.long()[fptr[1:]] - coo.chunk_ptr.long()[fptr[:-1]]
    own = torch.repeat_interleave(
        torch.arange(fptr.numel() - 1, device=B.device,
                     dtype=torch.int32), counts)
    ident = coo._replace(pos=torch.arange(coo.row.numel(), device=B.device,
                                          dtype=torch.int32))

    def call():
        pq = ops.pos_dot(phi, own, B, coo.row) * coo.val
        return ops.pos_scatter(ops.storage_scale(pq, w_scale), B, ident)
    return call


# the rank cell's shape (ocffm_bench kkbox-ffm-k64.rank-b1024): a request of
# 1,024 users over the 359,966 songs, its top 10, and the item-sharded
# evaluator's largest K (P@80); float32 as the cell and predict, bfloat16 as
# serve_bench and a bfloat16 evaluator
TOPK_SHAPE = (1024, 359_966)
TOPK_KS = (10, 80)


def topk_phase(device, gpu: str, report) -> None:
    """``topk_rows`` against its plain version (the stable descending
    sort's first K) on standard normal scores at ``TOPK_SHAPE``, for each
    of ``TOPK_KS``, float32 and bfloat16: ``compare``'s line (ids and
    values, two launches bit-identical, kernel / plain / ``torch.topk`` /
    bound times), then the value bits and the launches of its calls."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    g = torch.Generator(device=device).manual_seed(0)
    z32 = torch.randn(TOPK_SHAPE, generator=g, device=device)
    for dt_name in ("float32", "bfloat16"):
        z = z32 if dt_name == "float32" else z32.bfloat16()
        for k in TOPK_KS:
            side = f"{TOPK_SHAPE[0]}x{TOPK_SHAPE[1]} k={k}"
            before = kernels.launch_counts()["topk_rows"]
            compare("topk_rows", side, dt_name, (z, k), {}, report, gpu)
            vals, ids = ops.topk_rows(z, k)
            want_v, want_i = ops.topk_rows_plain(z, k)
            bits = (torch.equal(ids, want_i)
                    and torch.equal(vals.view(torch.int16),
                                    want_v.contiguous().view(torch.int16)))
            launches = kernels.launch_counts()["topk_rows"] - before
            print(f"[kernels] topk_rows {side} {dt_name}: ids and value "
                  f"bits equal to the stable sort's {bits}; {launches} "
                  f"launches; segments a row "
                  f"{kernels.topk_segs(*TOPK_SHAPE, k, z.dtype)} [{gpu}]")
            check(bits, f"topk_rows {side} {dt_name}: not the stable sort's "
                        f"first K")
            check(launches > 0, f"topk_rows {side} {dt_name}: no launch")
        del z
    del z32


# the table passes whose [kernels] line gives their X^T stage's time alone
XT_STAGED = ("pos_hv_tbl", "hv_self_tbl", "grad_self_tbl",
             "grad_self_tbl_diag", "grad_cross_tbl", "grad_cross_tbl_diag")


def xt_stage_ms(name: str, args) -> float:
    """The time of a table pass's X^T stage on its own over the kernel's
    feature-major list (the row stage's time is the rest of the kernel's):
    B4's and B5's on a payload of their shape and dtype, and for B5's
    Jacobi variant also its second launch, through X^2 on a second
    payload; B6's and B7's on their Q1 with a scale per row, and for B7's
    Jacobi variant also its second launch, through X^2 on Q1 with dd's
    scale, squared."""
    import torch

    from one_class_ffm_torch.ops import kernels

    lib = kernels.load()
    if name.startswith("grad_self_tbl"):
        xt, payload = args[0], args[1]
    elif name.startswith("grad_cross_tbl"):
        xt, payload = args[0], torch.randn_like(args[4])
    else:
        xt = args[3]
        payload = args[4] if name == "hv_self_tbl" else torch.randn(
            (args[1].shape[0], args[0].shape[1]),
            device=args[0].device).to(args[0].dtype)
    rows, dev, dt = payload.shape[0], payload.device, payload.dtype
    scale = (None if name in ("pos_hv_tbl", "grad_cross_tbl",
                              "grad_cross_tbl_diag")
             else torch.randn(rows, device=dev).to(dt))
    if name == "grad_self_tbl_diag":
        dd = args[6]
        return time_ms(lambda: (
            kernels._xt_scatter(lib, payload, xt, name, scale=scale),
            kernels._xt_scatter(lib, payload, xt, name, True, scale=dd,
                                payload_sq=True)))
    if name == "grad_cross_tbl_diag":
        payload_q = torch.randn_like(payload)
        return time_ms(lambda: (
            kernels._xt_scatter(lib, payload, xt, name),
            kernels._xt_scatter(lib, payload_q, xt, name, True)))
    return time_ms(lambda: kernels._xt_scatter(lib, payload, xt, name,
                                               scale=scale))


@contextlib.contextmanager
def recorded(obj, names, first_only: bool = False):
    """Record the arguments of every call (with ``first_only``, of the
    first call) of the named functions of ``obj`` (a module, or an
    instance's methods) while the block runs; restored on exit."""
    calls = {name: [] for name in names}
    own = {name: name in vars(obj) for name in names}
    saved = {name: getattr(obj, name) for name in names}

    def recording(name, fn):
        def call(*args, **kw):
            if not (first_only and calls[name]):
                calls[name].append((args, kw))
            return fn(*args, **kw)
        return call

    try:
        for name, fn in saved.items():
            setattr(obj, name, recording(name, fn))
        yield calls
    finally:
        for name, fn in saved.items():
            if own[name]:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)


@contextlib.contextmanager
def first_calls(names):
    """Record the arguments of the first call of each named kernel wrapper
    while the block is run (the solver reaches the wrappers through the
    ``kernels`` module); the wrappers are restored on exit, and the dict
    then holds each called wrapper's (args, kw)."""
    from one_class_ffm_torch.ops import kernels

    seen = {}
    with recorded(kernels, names, first_only=True) as calls:
        yield seen
    seen.update({name: c[0] for name, c in calls.items() if c})


def _cast(a, dt):
    """A recorded argument at storage dtype ``dt`` (float tensors and the
    feature-major list's values; indices and scalars as they are)."""
    import torch

    from one_class_ffm_torch.ops.layout import FeatureMajor

    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.to(dt).contiguous()
    if isinstance(a, FeatureMajor) and a.val is not None:
        v = a.val.to(dt)
        return a._replace(val=v, val_sq=None if a.val_sq is None else v * v)
    return a


@contextlib.contextmanager
def eager_cg(solver):
    """The solver's CG as one eager iteration per host read of the stop
    flag while the block runs: a phase that records the arguments the
    kernel wrappers receive needs them called, which a CUDA graph's replay
    does not."""
    saved = solver.cg_host_loop
    solver.cg_host_loop = True
    try:
        yield solver
    finally:
        solver.cg_host_loop = saved


def kernel_phase(trainer, cases, tag: str, gpu: str, report,
                 timed: bool = True) -> None:
    """Each kernel vs its plain version on the arguments the solver gives
    it in one real half-solve (its first call there), from a fresh init.
    ``cases``: (kernel names, block, first side?, side label); ``timed``:
    also time each kernel at float32 (``compare``)."""
    import torch

    solver = trainer.solver
    state = trainer.init_state()
    sa, sb = solver.sasb(state)
    for names, b, first, side in cases:
        with first_calls(names) as seen, eager_cg(solver):
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
        if xt is not None and xt.pos is not None:  # a COO side's list
            desc.append(f"list of the stream: rows={xt.feat_ptr.numel() - 1}"
                        f" gathering from {xt.n_rows} rows, "
                        f"entries={xt.row.numel()} "
                        f"chunks={xt.chunk_ptr.numel() - 1}")
        elif xt is not None:  # a feature field's X^T list
            desc.append(f"D={xt.feat_ptr.numel() - 1} rows={xt.n_rows} "
                        f"X entries={xt.row.numel()} "
                        f"chunks={xt.chunk_ptr.numel() - 1}")
        if "project" in seen:
            idx = seen["project"][0][0]
            desc.append(f"project rows={idx.shape[0]} p={idx.shape[1]}")
        if "scatter" in seen and seen["scatter"][0][0] is not xt:
            xs = seen["scatter"][0][0]  # a list the scatter has to itself
            desc.append(f"scatter D={xs.feat_ptr.numel() - 1} "
                        f"rows={xs.n_rows} X entries={xs.row.numel()}")
        print(f"[kernels] {tag} {side} side, {b.kind} block {b.f12}: "
              f"{' '.join(desc)}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for name in names:
                args, kw = seen[name]
                args = [_cast(a, dt) for a in args]
                kw = {key: _cast(a, dt) for key, a in kw.items()}
                compare(name, f"{tag} {side}", dt_name, args, kw, report,
                        gpu, timed=timed)
                if name == "scatter":  # the same list through X^2 (Jacobi)
                    compare(name, f"{tag} {side} X^2", dt_name,
                            [*args[:2], True], kw, report, gpu, timed=False)


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


def jacobi_cases(trainer):
    """The FFM solves under Jacobi whose gradient passes carry the Hessian
    diagonal's second output: the id fields' cross block (B2's payload, on
    the MF streams), the categorical fields' cross block (B5's) and each
    categorical self block (B7's)."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    scat, cross, self_ = (("pos_scatter_blocked_diag",),
                          ("grad_cross_tbl_diag",), ("grad_self_tbl_diag",))
    return [(scat, blocks[(0, fu)], True, "u"),
            (scat, blocks[(0, fu)], False, "v"),
            (cross, blocks[(1, fu + 1)], True, "u"),
            (cross, blocks[(1, fu + 1)], False, "v"),
            (self_, blocks[(1, 1)], True, "u"),
            (self_, blocks[(fu + 1, fu + 1)], True, "v")]


def skew_cases(trainer):
    """The skewed FFM's solves that run B1-B8: the id fields' cross block
    (B1-B3) and the categorical fields' cross block (B4, B5), both sides,
    and each categorical self block (B6, B7).  On a two-tier side these
    read its tail: a stream whose power rows own no slots.  On the v side
    (the head side) the categorical cross solve's first B8 call projects
    the head rows and its first X^T stage call scatters through the head
    rows' own list (the fused gradient's and Hv's head terms), shapes no
    other path gives them."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    cross = ("grad_cross_tbl", "pos_hv_tbl")
    self_ = ("grad_self_tbl", "hv_self_tbl")
    return [(BLOCKED, blocks[(0, fu)], True, "u"),
            (BLOCKED, blocks[(0, fu)], False, "v"),
            (cross, blocks[(1, fu + 1)], True, "u"),
            (cross + WIDE, blocks[(1, fu + 1)], False, "v"),
            (self_, blocks[(1, 1)], True, "u"),
            (self_, blocks[(fu + 1, fu + 1)], True, "v")]


def mesh_cases(trainer, kind: str = "blocked"):
    """A mesh rank's solves over its own rows, blocks, head chunks and
    lists.  ``blocked`` (the headline FFM, on a data or 2-D mesh): the id
    fields' cross block on both sides (B1-B3 on the rank's stream slice,
    local ``src``) and ``ffm_cases`` (B4-B8 and the X^T stage); ``skew``:
    ``skew_cases`` (B1-B7 on the tails, B8 and the X^T stage on the head
    rows of the rank's own power items); ``coo``: ``coo_cases`` (the X^T
    list passes and pos_dot over the rank's lists of the entries of its
    own rows)."""
    if kind == "skew":
        return skew_cases(trainer)
    if kind == "coo":
        return coo_cases(trainer)
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    b = blocks[(0, lay.fu)]
    return [(BLOCKED, b, True, "u"), (BLOCKED, b, False, "v"),
            *ffm_cases(trainer)]


def coo_sides(solver) -> str:
    """The sides that take the plain COO positive passes."""
    sides = [s for s in ("u", "v") if solver._coo(s == "u") is not None]
    return " and ".join(sides) or "none"


def coo_cases(trainer):
    """The FFM with both sides COO (blocked_bm=0, plain CG): the
    categorical fields' cross block on both sides (the gradient's
    ``pos_scatter`` and the Hv's ``pos_hv_coo`` over the solve's list,
    gathering the other side's cache, the step's gaps by ``pos_dot`` over
    the stream; off the fused passes, B8 projects and the X^T stage
    scatters through the field's list, D=1000 over the u rows, D=500 over
    the v rows) and each categorical self block (``pos_seg_sum``)."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    cross = ("pos_scatter", "pos_hv_coo", "pos_dot") + WIDE
    return [(cross, blocks[(1, fu + 1)], True, "u"),
            (cross, blocks[(1, fu + 1)], False, "v"),
            (("pos_seg_sum",), blocks[(1, 1)], True, "u"),
            (("pos_seg_sum",), blocks[(fu + 1, fu + 1)], True, "v")]


def skew_coo_cases(trainer):
    """The skewed FFM under Jacobi with its v side COO (head_chunk=0): the
    categorical cross block's v solve (the gradient's and diagonal's
    ``pos_scatter_pair``, the Hv's ``pos_hv_coo``, the gaps' ``pos_dot``)
    and the v self block (``pos_seg_sum``), on a list whose power items
    span hundreds of chunks.  Off the fused passes, the cross solve
    projects (B8) and scatters (the X^T stage) through the skewed data's
    field list, through X^2 for the diagonal."""
    lay = trainer.solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    return [(("pos_scatter_pair", "pos_hv_coo", "pos_dot") + WIDE,
             blocks[(1, fu + 1)], False, "v"),
            (("pos_seg_sum",), blocks[(fu + 1, fu + 1)], True, "v")]


# the head ops of a two-tier side, as the solver calls them: (label, name
# in torch_solver or method of the solver)
HEAD_OPS = (("rows_hd gather", "gather_blocked_rows"),
            ("head_hv (row-space Hv term)", "head_hv"),
            ("fused Hv head term", "_hd_hv_tbl"),
            ("hd_tbl (fused gradient term)", "_hd_tbl"),
            ("head_scatter (row-space gradient term)", "head_scatter"),
            ("head_seg_sum (self gradient term)", "head_seg_sum"),
            ("head gap (head_pq of the step)", "head_pq"))


def record_head_ops(trainer):
    """{label: (function, args, kw)}: each head op's first call on the v
    side (the head side of the skewed FFM) in three real half-solves from
    the trainer's state: the id fields' cross block (the row-space Hv and
    gradient terms, the gap), the categorical fields' (the fused terms)
    and the categorical v self block (the per-row sums); the gather is the
    one that reads ``hd_take``."""
    from one_class_ffm_torch.solver import torch_solver as ts

    solver, state = trainer.solver, trainer.state
    sa, sb = solver.sasb(state)
    lay = solver.meta.layout
    blocks = {(b.f1, b.f2): b for b in lay.all_blocks()}
    fu = lay.fu
    mod = [n for _, n in HEAD_OPS if not n.startswith("_")]
    meth = [n for _, n in HEAD_OPS if n.startswith("_")]
    with recorded(ts, mod) as calls, recorded(solver, meth) as mcalls, \
            eager_cg(solver):
        for b, first in ((blocks[(0, fu)], False),
                         (blocks[(1, fu + 1)], False),
                         (blocks[(fu + 1, fu + 1)], True)):
            solver._solve_half(state, b, first, sa, sb)
    calls.update(mcalls)
    hd_take = solver.data["blk_v_hd_take"]
    calls["gather_blocked_rows"] = [
        c for c in calls["gather_blocked_rows"] if c[0][1] is hd_take]
    out = {}
    for label, name in HEAD_OPS:
        check(calls[name], f"FFM skew: {name} was not called on the v side")
        fn = getattr(solver if name.startswith("_") else ts, name)
        out[label] = (fn, *calls[name][0])
    return out


def head_op_phase(trainer, gpu: str) -> None:
    """Per-call ms (CUDA events, ``time_ms``) of each head op on its
    recorded arguments (``record_head_ops``)."""
    ops = record_head_ops(trainer)
    fn, args, kw = ops["rows_hd gather"]
    nch, chunk = args[1].shape
    print(f"[main ffm-skew] head ops, v side: head stream {nch} chunks x "
          f"{chunk} x k {args[0].shape[1]} ({args[0].dtype}), "
          f"{trainer.solver.data['blk_v_hd_rows'].numel()} head rows")
    for label, (fn, args, kw) in ops.items():
        ms = time_ms(lambda: fn(*args, **kw))
        print(f"[main ffm-skew] head op {label}: {ms:.4f} ms per call "
              f"[{gpu}]")


def _same_state(a, b) -> bool:
    """Two states' tables, caches, side sums and residuals bit for bit."""
    import torch

    def same(x, y):
        return x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))

    ok = True
    for key in ("P", "Q"):
        ok = ok and all(same(a[key][f], b[key][f]) for f in a[key])
    for f12, blk in a["params"].items():
        ok = ok and all(same(t, b["params"][f12][n]) for n, t in blk.items())
    for key, t in a.items():
        if isinstance(t, torch.Tensor):
            ok = ok and same(t, b[key])
    return ok


def _bits(t):
    """A tensor's bit patterns (torch.equal holds -0.0 equal to +0.0)."""
    import torch

    view = {8: torch.int64, 4: torch.int32, 2: torch.int16}
    return t.contiguous().view(view[t.element_size()])


def check_repeatable(tag: str, trainer) -> None:
    """Two runs of one epoch from the same state give the same bits (no
    float atomics on the path)."""
    import torch

    a, ia = trainer.solver.epoch_stats(trainer.state)
    b, ib = trainer.solver.epoch_stats(trainer.state)
    same = torch.equal(ia, ib) and _same_state(a, b)
    print(f"[main {tag}] one epoch twice from the same state: the same bits "
          f"{same}")
    check(same, f"{tag}: two runs of one epoch differ")


def loop_check(tag: str, trainer, gpu: str) -> dict:
    """One epoch from the trainer's state on the device loop (CUDA graph
    replays of ``cg_group`` iterations, a host read of the stop flag per
    replay) and on the host loop (one eager iteration per host read): the
    same tables, caches, residuals and CG counts, bit for bit.  Prints each
    loop's epoch seconds and host reads, the replays, the iterations run
    after their solve's stop and their device time: each graph replayed on
    a stopped solve (its Hv runs, the recurrence writes nothing), by CUDA
    events, times its masked iterations in the epoch."""
    import torch

    solver = trainer.solver
    check(solver._graph_path(), f"{tag}: the solver is not on the CUDA "
                                "graph path")
    graphs = solver._graphs.graphs
    masked0 = {k: e.masked for k, e in graphs.items()}
    c0 = dict(solver.cg_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev, dev_it = solver.epoch_stats(trainer.state)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    c1 = dict(solver.cg_counts)
    with eager_cg(solver):
        t0 = time.perf_counter()
        host, host_it = solver.epoch_stats(trainer.state)
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t0
    c2 = dict(solver.cg_counts)
    same = torch.equal(dev_it, host_it) and _same_state(dev, host)
    masked_ms = 0.0
    for key, e in graphs.items():
        n = e.masked - masked0.get(key, 0)
        if n:
            masked_ms += n * time_ms(e.graph.replay, reps=5, rounds=3,
                                     warm_ms=2.0) / e.group
    out = dict(dev_s=t_dev, host_s=t_host,
               reads=c1["reads"] - c0["reads"],
               host_reads=c2["reads"] - c1["reads"],
               replays=c1["replays"] - c0["replays"],
               masked=c1["masked"] - c0["masked"], masked_ms=masked_ms,
               iters=int(dev_it.sum()), solves=dev_it.numel())
    print(f"[main {tag}] device loop vs host loop, one epoch from one state: "
          f"the same bits and CG counts {same}; device loop "
          f"{t_dev:.4f} s, {out['reads']} host reads of the stop flag, "
          f"{out['replays']} graph replays of {solver.cg_group} iterations, "
          f"{out['masked']} masked iterations ({masked_ms:.4f} ms of device "
          f"time); host loop {t_host:.4f} s, {out['host_reads']} host "
          f"reads; {out['iters']} iterations in {out['solves']} solves "
          f"[{gpu}]")
    check(same, f"{tag}: the device loop's epoch is not the host loop's")
    return out


def cg_work(name: str, n: int, storage_bytes: int, jacobi: bool):
    """(bytes, operations) of the recurrence on n elements: cg_init reads G
    (and D) and writes S, R and V (and V at storage below float32); an
    iteration (cg_step) reads S, R, V and Hv (and D) and writes S, R and V
    (and V at storage), with the products and sums of den, S, R, r2 and V
    (and Z = R / D and rz), each counted once."""
    low = storage_bytes < 4  # V at storage is its own array
    if name == "cg_init":
        nbytes = n * (4 + 4 * jacobi + 12 + storage_bytes * low)
        return nbytes, n * (2 + 3 * jacobi)
    nbytes = n * (12 + storage_bytes + 4 * jacobi + 12 + storage_bytes * low)
    return nbytes, n * (10 + 3 * jacobi)


def _eager_step(st, Hv, storage):
    """The port's recurrence before the kernel: the eager torch operations
    of one iteration after the Hv (its host read of the stop test left
    out), the yardstick of cg_step."""
    import torch

    ct = st.S.dtype
    one = torch.ones((), dtype=ct, device=Hv.device)
    zero = torch.zeros((), dtype=ct, device=Hv.device)
    rz = torch.ones((), dtype=ct, device=Hv.device)
    D = st.D

    def call():
        Hc = Hv.to(ct)
        den = (st.V * Hc).sum()
        ok = den > 0
        alpha = torch.where(ok, rz / torch.where(ok, den, one), zero)
        S = st.S + alpha * st.V
        R = st.R - alpha * Hc
        r2 = torch.where(ok, (R * R).sum(), zero)
        rz_safe = torch.where(rz > 0, rz, one)
        if D is None:
            V = R + (r2 / rz_safe) * st.V
        else:
            Z = R / D
            V = Z + ((R * Z).sum() / rz_safe) * st.V
        return S, V.to(storage)
    return call


def cg_phase(trainer, b, sides, tag: str, gpu: str, report,
             timed: bool = True) -> None:
    """The recurrence kernels (cg_ops.cu) against their plain versions on
    the arguments real half-solves of block ``b`` give them, each side of
    ``sides`` from a fresh init: cg_init's G (and D) and the first cg_step's
    Hv, at float32 and bfloat16 storage; the vectors and the scalars after
    the start and after one step bit for bit.  At float32 (``timed``) the
    kernel, plain and eager-sequence times and the bound of the work: the
    step on a state re-armed before each call (its done flag cleared, which
    is timed alone and taken off), so every timed step does its whole
    work."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    solver = trainer.solver
    state = trainer.init_state()
    sa, sb = solver.sasb(state)
    for first in sides:
        side = "u" if first else "v"
        with recorded(kernels, CG, first_only=True) as calls, \
                eager_cg(solver):
            solver._solve_half(state, b, first, sa, sb)
        check(calls["cg_init"] and calls["cg_step"],
              f"{tag} {side}: the recurrence kernels were not called")
        G0, D, _, eps, cap = calls["cg_init"][0][0]
        Hv0 = calls["cg_step"][0][0][1]
        n = G0.numel()
        cfg = kernels.cg_config(n, G0.device)
        print(f"[kernels] {tag} {side} side, {b.kind} block {b.f12}: CG "
              f"vectors {tuple(G0.shape)} ({n} elements, {cfg.ctas} CTAs "
              f"of {cfg.threads}, loads of {4 if cfg.vec else 1}), Jacobi "
              f"{D is not None}")
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            G, Hv = G0.to(dt), Hv0.to(dt)
            st_k = kernels.cg_init(G, D, dt, eps, cap)
            st_p = ops.cg_init_plain(G, D, dt, eps, cap)
            eq_init, err_init = _cg_agree(st_k, st_p)
            kernels.cg_step(st_k, Hv)
            ops.cg_step_plain(st_p, Hv)
            eq_step, err_step = _cg_agree(st_k, st_p)
            for name, eq, err in (("cg_init", eq_init, err_init),
                                  ("cg_step", eq_step, err_step)):
                r = report[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                line = (f"[kernels] {name:24s} {tag} {side} {dt_name:8s} "
                        f"bit-equal {eq} max-abs {err:.3e}")
                if timed and dt_name == "float32":
                    line += _cg_times(name, G, D, Hv, dt, eps, cap, r, gpu)
                print(line)
                check(eq, f"{name} {tag} {side} {dt_name}: not its plain "
                          "version's bits")


def _cg_agree(st_k, st_p):
    """(bit-equal, max |difference|) of the kernel's and the plain
    version's S, R, V, V at storage and scalars."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    torch.cuda.synchronize()
    eq, err = True, 0.0
    for name in ("S", "R", "V", "Vs"):
        a, b = getattr(st_k, name), getattr(st_p, name)
        eq = eq and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        err = max(err, (a.double() - b.double()).abs().max().item())
    sk, sp = kernels.cg_scalars(st_k), ops.cg_scalars(st_p)
    return eq and all(sk[k] == sp[k] for k in ("g2", "r2", "rz", "thr",
                                                "it", "done")), err


def _cg_times(name, G, D, Hv, dt, eps, cap, r, gpu) -> str:
    """Times of cg_init or cg_step (kernel, plain, the eager sequence) and
    the bound, added to the report ``r``; returns the line's tail."""
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    n = G.numel()
    st = kernels.cg_state(tuple(G.shape), dt, D is not None, 1 << 30,
                          G.device)
    kernels.cg_init(G, D, dt, 0.0, 1 << 30, out=st)
    st_p = ops.cg_init_plain(G, D, dt, 0.0, 1 << 30)
    if name == "cg_init":
        def kern():
            kernels.cg_init(G, D, dt, eps, 1 << 30, out=st)
        ms = time_ms(kern)
        dms, calls = device_ms(kern, events=CG_KERNELS[name])
        pms = time_ms(lambda: ops.cg_init_plain(G, D, dt, eps, cap))
        eager = None
    else:
        done = st.sc[kernels._DONE:kernels._DONE + 1]

        def kern():
            done.zero_()
            kernels.cg_step(st, Hv)
        ms = time_ms(kern) - time_ms(done.zero_)
        dms, calls = device_ms(kern, events=CG_KERNELS[name])
        dms -= device_ms(done.zero_)

        def plain():
            st_p.sc["done"] = False
            ops.cg_step_plain(st_p, Hv)
        pms = time_ms(plain)
        eager = time_ms(_eager_step(st_p, Hv, dt))
    nbytes, nops = cg_work(name, n, Hv.element_size(), D is not None)
    bms, by = bound_of(nbytes, nops)
    r["ms"] += ms
    r["plain_ms"] += pms
    r["nbytes"] += nbytes
    r["ops"] += nops
    return (f"  kernel {ms:.4f} ms (device {dms:.4f} ms)  plain {pms:.4f} "
            f"ms  eager sequence "
            f"{'none' if eager is None else f'{eager:.4f} ms'}  bound "
            f"{bms:.4f} ms by {by} ({nbytes} B, {nops} ops); "
            f"{calls:g} launches per "
            f"{'start' if name == 'cg_init' else 'iteration'}; "
            f"{_cg_launch(name, n, dt, D is not None)}  [{gpu}]")


# the kernels of each recurrence entry, this tree's and the three-launch
# step's before it (which chip_smoke.py cg-kernels times beside it)
CG_KERNELS = {"cg_init": ("cg_init_kernel",),
              "cg_step": ("cg_iter_kernel", "cg_dot_kernel",
                          "cg_update_kernel", "cg_dir_kernel")}


def _cg_launch(name: str, n: int, dt, jacobi: bool) -> str:
    """The launch of cg_init or cg_step at n elements: the hardware grid
    (the step's plan: virtual CTAs a CTA, V's loads kept in shared
    memory), CTAs an SM on the card, and each kernel's registers and
    stack (a spill) from cuobjdump."""
    import torch

    from one_class_ffm_torch.ops import kernels

    dev = torch.device("cuda", 0)
    cfg = kernels.cg_config(n, dev)
    if not hasattr(kernels, "cg_plan"):  # the three-launch step
        out = f"virtual launch {cfg.ctas} x {cfg.threads}"
    elif name == "cg_init":
        blocks = kernels.cg_blocks(False, cfg.threads, 0, dt, jacobi, dev)
        out = (f"grid {cfg.ctas} x {cfg.threads} (the virtual launch), "
               f"{blocks} CTAs an SM")
    else:
        plan = kernels.cg_plan(n, dev)
        blocks = kernels.cg_blocks(True, cfg.threads, plan.smem, dt, jacobi,
                                   dev)
        out = (f"grid {plan.grid} x {cfg.threads} for {cfg.ctas} virtual "
               f"CTAs ({plan.per} a CTA), V of {plan.cache} of {plan.loads} "
               f"loads in {plan.smem} B of shared memory, {blocks} CTAs an "
               f"SM")
    if not _REGS:
        _REGS.update(kernel_registers(str(kernels.library_path())) or {})
    dt_name = "bf16" if dt == torch.bfloat16 else "f32"
    regs = [f"{k} {v[0]} registers, {v[2]} B stack"
            for (k, d, jac, _), v in sorted(_REGS.items())
            if k in CG_KERNELS[name] and d == dt_name and jac == jacobi]
    return out + "; " + (", ".join(regs) or "registers not measured")


def variant_phase(trainer, gpu: str, report) -> None:
    """B9 and B10 on the arguments B1 receives in a real MF half-solve, on
    each side, with B1's static row runs: B9 on the stream packed as the
    TPU experiment packed it (the packing keeps slot order), B10
    at G = 2 where the block count allows it (u: 782 blocks) and G = 1
    otherwise (v: 79 blocks, a prime).  Each against its plain version and
    against B1's output on the same inputs, at float32 and bfloat16."""
    import torch

    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    solver = trainer.solver
    state = trainer.init_state()
    b = solver.meta.layout.cross_blocks()[0]
    for first, side in ((True, "u"), (False, "v")):
        with first_calls(("pos_hv_blocked",)) as seen, eager_cg(solver):
            solver._solve_half(state, b, first, None, None)
        args, kw = seen["pos_hv_blocked"]
        groups = 2 if args[1].shape[0] % 2 == 0 else 1
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            a = [_cast(x, dt) for x in args]
            phi, rows, own, w, dense, num, bm, w_scale = a
            b1 = kernels.pos_hv_blocked(*a, **kw)
            compare("pos_hv_packed", f"MF {side}", dt_name,
                    [phi, *ops.pack_rows(rows, own, w), dense, num, bm,
                     w_scale], kw, report, gpu, same_as=b1)
            compare("pos_hv_blocked_g", f"MF {side} G={groups}", dt_name,
                    [phi, rows, own, w, dense, num, bm, groups, w_scale], kw,
                    report, gpu, same_as=b1)


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


def _without_repeated_ids(data):
    """The data with each row's repeated feature ids dropped (value 0 after
    the first).  The Jacobi diagonal squares X slot by slot, as the JAX
    package does (its kernels' _xoh_block(square=True), its _scat_sq): that
    is the oracle's dense X^2 unless a row holds one feature twice, which
    the synthetic categorical fields do in a few rows."""
    import dataclasses

    import numpy as np

    def side(pf):
        vals = []
        for idx, val in zip(pf.idx, pf.val):
            val = val.copy()
            live = val != 0
            for s_ in range(1, idx.shape[1]):
                rep_ = (idx[:, :s_] == idx[:, s_:s_ + 1]) & live[:, :s_]
                val[rep_.any(axis=1) & live[:, s_], s_] = 0
            vals.append(val)
        return dataclasses.replace(pf, val=tuple(vals))

    return dataclasses.replace(data, u_pad=side(data.u_pad),
                               v_pad=side(data.v_pad))


def reference_phase(device, tag: str, cg_precond: str = "auto") -> None:
    """Small MF problem, small FFM problem with self blocks, small FM
    problem with self blocks whose fields are above a lowered fused-table
    cap, or (``skew``) the small FFM problem with two power rows on each
    side, whose layouts at 32 rows per block take the head tier of 16-slot
    chunks on both sides; ``coo``: the small FFM with both sides COO
    (blocked_bm=0); ``mixed``: the small FFM with item popularity zipf 1.0
    at 8 rows per block and head_chunk=0, its v side COO and its u side
    blocked: the kernel-driven gradient and Hv of every block
    side and the tracked objective on the card against the fp64 numpy
    oracle.  Under Jacobi also the Hessian diagonal of every block side
    against ``oracle.diag_hessian``, and two epochs against
    ``oracle_epoch``."""
    import numpy as np
    import torch

    from one_class_ffm_torch.solver import oracle
    from one_class_ffm_torch.solver.convert import params_to_numpy

    jacobi = cg_precond == "jacobi"
    if jacobi:
        tag += " jacobi"
    if tag == "MF":
        data = build_data(2048, 512, 5.0, seed=3)
        tr = make_trainer(data, device, k=8)
    elif tag.startswith(("coo", "mixed")):
        mixed = tag.startswith("mixed")
        data = build_data(1024, 256, 5.0, seed=3, dims_u=(1024, 40),
                          dims_v=(256, 24), self_side=True,
                          pop_skew=1.0 if mixed else 0.0)
        if jacobi:
            data = _without_repeated_ids(data)
        # zipf 1.0 over 256 items: at 8 rows per block the v side's
        # heaviest block pads past the budget, the u side's does not
        layout = (dict(blocked_bm=8, head_chunk=0) if mixed
                  else dict(blocked_bm=0))
        tr = make_trainer(data, device, k=8, cg_precond=cg_precond, **layout)
        sides = coo_sides(tr.solver)
        check(sides == ("v" if mixed else "u and v"),
              f"{tag} reference: COO sides {sides}")
        print_static_plan(tag, tr.solver.data)
    else:
        fm, skew = tag.startswith("FM"), tag.startswith("skew")
        data = build_data(1024, 256, 5.0, seed=3, dims_u=(1024, 40),
                          dims_v=(256, 24), self_side=True, fm=fm,
                          power=2 if skew else 0)
        if jacobi:
            data = _without_repeated_ids(data)
        layout = dict(blocked_bm=32, head_chunk=16) if skew else {}
        with fused_cap(8) if fm else contextlib.nullcontext():
            tr = make_trainer(data, device, k=8, cg_precond=cg_precond,
                              **layout)
        if skew:
            check(tr.solver.hd_u and tr.solver.hd_v,
                  f"{tag} reference: the head tier is not on both sides")
            print_static_plan(tag, tr.solver.data)
    solver = tr.solver
    check(solver.cg_precond == ("jacobi" if jacobi else "none"),
          f"{tag} reference: CG is {solver.cg_precond}")
    if tag.startswith("FM"):
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
    worst_g = worst_h = worst_d = 0.0
    for b in data.layout.all_blocks():
        for first in (True, False):
            G, hv, _, _, D = solver.solve_inputs(state, b, first, sa, sb)
            G_ref, hv_ref = oracle.grad_and_hv(prob, ref_params, b, first)
            V = rng.normal(size=G_ref.shape)
            H = hv(torch.as_tensor(V, dtype=solver.meta.dtype,
                                   device=device))
            worst_g = max(worst_g, rel(G.double().cpu().numpy(), G_ref))
            worst_h = max(worst_h, rel(H.double().cpu().numpy(),
                                       hv_ref(V)))
            if jacobi:
                worst_d = max(worst_d, rel(
                    D.double().cpu().numpy(),
                    oracle.diag_hessian(prob, ref_params, b, first)))
    print(f"[reference] {tag}: {len(data.layout.all_blocks())} blocks x 2 "
          f"sides vs fp64 oracle: gradient max-rel {worst_g:.3e}, Hv "
          f"max-rel {worst_h:.3e}" + (
              f", Jacobi diagonal max-rel {worst_d:.3e}" if jacobi else ""))
    check(worst_g < 1e-4, f"{tag} gradient disagrees with the oracle: "
                          f"{worst_g:.3e}")
    check(worst_h < 1e-4, f"{tag} Hv disagrees with the oracle: "
                          f"{worst_h:.3e}")
    check(worst_d < 1e-4, f"{tag} Jacobi diagonal disagrees with the "
                          f"oracle: {worst_d:.3e}")
    oracle_params = ref_params
    for ep in range(2):
        state, iters = solver.epoch_stats(state)
        got = float(solver.objective(state))
        ref = oracle.objective(prob, dense_params(state))
        r = abs(got - ref) / abs(ref)
        print(f"[reference] {tag} epoch {ep + 1} objective {got:.6f} vs "
              f"oracle {ref:.6f}: rel {r:.3e}; CG iterations per solve "
              f"{iters.tolist()}")
        check(r < 1e-4, f"{tag} tracked objective disagrees with the "
                        f"oracle: {r:.3e}")
        if not jacobi:
            continue
        # the oracle's own Jacobi epoch from the same start, at float64:
        # a float32 solve may stop one CG iteration apart from it (the
        # 0.09 relative stop rule), so the bound is on the objective
        oracle_params = oracle.oracle_epoch(prob, oracle_params)
        ref_ep = oracle.objective(prob, oracle_params)
        got_p = dense_params(state)
        p_rel = max(rel(got_p[n][f], oracle_params[n][f])
                    for n in ("W", "H") for f in got_p["W"])
        r = abs(got - ref_ep) / abs(ref_ep)
        print(f"[reference] {tag} epoch {ep + 1} vs oracle_epoch: objective "
              f"{got:.6f} vs {ref_ep:.6f}, rel {r:.3e}; tables max-rel "
              f"{p_rel:.3e}")
        check(r < 1e-2, f"{tag} epoch {ep + 1} objective is {r:.3e} from "
                        "oracle_epoch's")


def profile_epoch(tag: str, trainer, gpu: str) -> None:
    """One more epoch under torch.profiler (``device_profile``)."""
    def epoch():
        trainer.state, _ = trainer.solver.epoch_stats(trainer.state)

    device_profile(f"main {tag}", "profiled epoch", epoch, gpu)


def _busy_window(prof):
    """(busy, window) in us of a torch.profiler trace: the union of its
    device events' intervals, and the span of all its events; (None, None)
    without device events."""
    import torch

    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        return None, None
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
    return busy, hi - lo


def device_profile(label: str, what: str, fn, gpu: str) -> None:
    """``fn()`` under torch.profiler: the device's idle share (1 - the
    union of the kernels' intervals over the window) and the kernels that
    take the device time (the top eight, then every other kernel of the
    port's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, window = _busy_window(prof)
    if busy is None:
        print(f"[{label}] {what} {wall:.4f} s: no device events "
              f"in the trace, idle share not measured [{gpu}]")
        return
    print(f"[{label}] {what} {wall:.4f} s: device busy "
          f"{busy / 1e3:.3f} ms of {window / 1e3:.3f} ms, idle share "
          f"{1.0 - busy / window:.4f} [{gpu}]")
    rows = sorted(prof.key_averages(),
                  key=lambda a: a.self_device_time_total, reverse=True)
    # the top eight, then the rest of the kernels in anonymous namespaces:
    # all of the port's own (csrc/*.cu) and a few of torch's
    for i, a in enumerate(rows):
        if a.self_device_time_total <= 0:
            break
        if i < 8 or a.key.startswith("void (anonymous namespace)::"):
            print(f"[{label}]   {a.self_device_time_total / 1e3:9.3f} ms "
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
    res["launches"] = launches
    return launches, res


def write_feature_rows(path: str, pf, m: int) -> str:
    """The first ``m`` rows of a side's padded fields as unlabeled text rows
    (``field:index:value`` in field then slot order, pad slots left out),
    which ``read_data`` turns back into the same rows."""
    with open(path, "w") as out:
        for i in range(m):
            out.write(" ".join(
                f"{f}:{idx}:{float(val)!r}"
                for f in range(pf.f)
                for idx, val in zip(pf.idx[f][i].tolist(),
                                    pf.val[f][i].tolist()) if val != 0)
                + "\n")
    return path


@contextlib.contextmanager
def plain_projection():
    """predict's projections through ``project_plain`` (plain torch on the
    tensors' device) in place of the dispatcher, which launches B8."""
    from one_class_ffm_torch import predict
    from one_class_ffm_torch.ops import sparse_ops

    saved = predict.project
    predict.project = sparse_ops.project_plain
    try:
        yield
    finally:
        predict.project = saved


def serve_split(layout, tables, v_pad, u_pad, popular, device,
                top_k: int = 10, chunk: int = 2048):
    """predict_topk_from_model's device work on rows already read, phase by
    phase, each phase ended by a device sync: (ids, seconds of the
    projections (items and users), of the scores, of the ranking and the
    ids' copy to the host)."""
    import numpy as np
    import torch

    from one_class_ffm_torch import predict

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    v_idx, v_val = [dev(a) for a in v_pad.idx], [dev(a) for a in v_pad.val]
    u_idx, u_val = [dev(a) for a in u_pad.idx], [dev(a) for a in u_pad.val]
    cold = dev(u_pad.row_nnz == 0)
    pop = np.zeros(v_pad.m, np.float32)
    pop[:min(len(popular), v_pad.m)] = popular[:v_pad.m]
    pop = dev(pop)
    cat = v_pad.m_true
    sync()
    t0 = time.perf_counter()
    Q, bt = predict.item_side(layout, tables, v_idx, v_val)
    slices = [slice(lo, min(lo + chunk, u_pad.m_true))
              for lo in range(0, u_pad.m_true, chunk)]
    P = [predict.project_users(layout, tables, [a[sl] for a in u_idx],
                               [a[sl] for a in u_val]) for sl in slices]
    sync()
    t_proj, t_score, t_rank = time.perf_counter() - t0, 0.0, 0.0
    ids = []
    for sl, Pc in zip(slices, P):
        t0 = time.perf_counter()
        z = torch.where(cold[sl][:, None], pop[None, :],
                        predict.catalog_scores(layout, Pc, Q, bt))
        sync()
        t1 = time.perf_counter()
        ids.append(predict.rank_topk(z[:, :cat], top_k)[1])
        sync()
        t_score += t1 - t0
        t_rank += time.perf_counter() - t1
    t0 = time.perf_counter()
    ids = torch.cat(ids).cpu().numpy()
    return ids, t_proj, t_score, t_rank + time.perf_counter() - t0


def serve_phase(trainer, device, gpu: str, reps: int = 3):
    """The serving path on a trained model: its text model and checkpoint,
    its item rows and its test users' feature rows written to files, then
    ``predict_topk_from_model`` over every test user x the full catalog,
    top 10, from the checkpoint (B8 must launch: the launch counts are set
    to 0 just before and read just after), against the same call with the
    projections on ``project_plain`` (identical ids), against
    ``Trainer.predict_topk`` (at least 0.99 of the top-10 ids shared; the
    two differ by the rounding of the carried item caches and near-ties)
    and from the text model (6 significant digits: printed, not gated);
    then users/s over the device work, best of ``reps``, split into
    projection, scoring and ranking.  Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from one_class_ffm_torch import predict
    from one_class_ffm_torch.data.dataset import (
        pad_fields,
        read_data,
        split_fields,
    )
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.solver.convert import params_from_numpy
    from one_class_ffm_torch.train import save_text_model

    d, top_k = trainer.data, 10
    work = os.path.join(WORK, "serve_ffm")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    model = os.path.join(work, "model.txt")
    save_text_model(model, trainer.params_numpy(), d.layout, trainer.cfg.k)
    ckpt = os.path.join(work, "ck")
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=ckpt)
    trainer.save_checkpoint()
    items = write_feature_rows(os.path.join(work, "items.ffm"), d.v_pad,
                               d.n_items_true)
    users = write_feature_rows(os.path.join(work, "users.ffm"), d.uva_pad,
                               d.uva_pad.m_true)
    print(f"[serve ffm] text model, checkpoint, {d.n_items_true} item rows "
          f"and {d.uva_pad.m_true} test users' rows written in "
          f"{time.perf_counter() - t0:.1f} s")

    def call(source, plain=False):
        lay, k, params = predict.load_any_model(*source)
        t0 = time.perf_counter()
        with plain_projection() if plain else contextlib.nullcontext():
            ids, _ = predict.predict_topk_from_model(
                lay, k, params, items, users, top_k, popular=d.popular,
                device=device)
        return ids, time.perf_counter() - t0

    kernels.reset_launch_counts()
    ids, secs = call((None, ckpt))
    launches = kernels.launch_counts()
    print(f"[serve ffm] predict_topk_from_model (checkpoint): {ids.shape[0]} "
          f"users x {d.n_items_true} items, top {top_k}, in {secs:.2f} s "
          f"(reading the files included); kernel launches "
          f"{ {n: c for n, c in launches.items() if c} } [{gpu}]")
    check(ids.shape == (d.uva_pad.m_true, top_k),
          f"serve ffm: ids of shape {ids.shape}")
    if torch.device(device).type == "cuda":  # (the CPU runs the plain ops)
        check(launches["project"] > 0, "project (B8) never launched on the "
                                       "serving path")
        check(launches["topk_rows"] > 0, "topk_rows never launched on the "
                                         "serving path")
    plain_ids, _ = call((None, ckpt), plain=True)
    same = bool(np.array_equal(ids, plain_ids))
    print(f"[serve ffm] ids equal to the project_plain route's: {same}")
    check(same, "serve ffm: B8's route ranks otherwise than project_plain's")
    want = trainer.predict_topk(top_k)
    shared = float(np.mean([len(set(a) & set(b)) / top_k
                            for a, b in zip(ids.tolist(), want.tolist())]))
    print(f"[serve ffm] top-{top_k} ids shared with Trainer.predict_topk: "
          f"{shared:.6f} (same order on {np.mean(np.all(ids == want, 1)):.6f}"
          f" of the users)")
    check(shared >= 0.99, f"serve ffm: only {shared:.4f} of the top-{top_k} "
                          "ids shared with Trainer.predict_topk")
    text_ids, secs = call((model, None))
    text_shared = np.mean(text_ids[:, :, None] == ids[:, None, :]) * top_k
    print(f"[serve ffm] text model route ({secs:.2f} s): top-{top_k} ids "
          f"equal to the checkpoint's on "
          f"{np.mean(np.all(text_ids == ids, 1)):.6f} of the users, "
          f"shared {text_shared:.6f}")

    lay, _, params = predict.load_any_model(None, ckpt)
    v_fd = split_fields(read_data(items, has_label=False, ds=list(lay.Dv)),
                        f_override=lay.fv)
    u_fd = split_fields(read_data(users, has_label=False, ds=list(lay.Du)),
                        f_override=lay.fu)
    v_pad, u_pad = pad_fields(v_fd), pad_fields(u_fd)
    tables = params_from_numpy(params, device)
    runs = []
    for _ in range(reps):
        got, *split = serve_split(lay, tables, v_pad, u_pad, d.popular,
                                  device, top_k)
        check(np.array_equal(got, ids), "serve ffm: the timed run's ids "
                                        "differ from predict's")
        runs.append(split)
    for i, (proj, sc, rank) in enumerate(runs):
        total = proj + sc + rank
        print(f"[serve ffm] run {i + 1}: {u_pad.m_true / total:.1f} users/s "
              f"({total:.4f} s: projection {proj:.4f}, scoring {sc:.4f}, "
              f"ranking {rank:.4f} s) [{gpu}]")
    best = min(runs, key=sum)
    print(f"[serve ffm] best of {reps}: {u_pad.m_true / sum(best):.1f} "
          f"users/s, {u_pad.m_true * v_pad.m_true / sum(best):.1f} pair "
          f"scores/s; ranking share {best[2] / sum(best):.4f} [{gpu}]")
    if torch.device(device).type == "cuda":
        device_profile("serve ffm", "profiled predict_topk_from_model",
                       lambda: call((None, ckpt)), gpu)
    return launches


def entry_phase(device, gpu: str):
    """The scoring entry point on ``device``: its step on its example
    arguments gives finite (64, 32) scores, equal to the same step with
    the projections on ``project_plain``.  Returns the launch counts."""
    import torch

    from one_class_ffm_torch.entry import entry
    from one_class_ffm_torch.ops import kernels

    fn, args = entry(device)
    kernels.reset_launch_counts()
    z = fn(*args)
    launches = kernels.launch_counts()
    with plain_projection():
        same = bool(torch.equal(z, fn(*args)))
    print(f"[entry] scores {tuple(z.shape)} on {z.device}, finite "
          f"{bool(torch.isfinite(z).all())}, equal to the project_plain "
          f"step's {same}; kernel launches "
          f"{ {n: c for n, c in launches.items() if c} } [{gpu}]")
    check(tuple(z.shape) == (64, 32) and bool(torch.isfinite(z).all())
          and same, "entry: wrong scores")
    return launches


def serve_bench_phase(device, gpu: str) -> None:
    """serve_bench at its defaults, in process: its JSON line, the
    torch.topk yardstick's and the ``topk_rows`` launches of its bfloat16
    ranking (on the card every chunk's)."""
    import torch

    from one_class_ffm_torch import serve_bench
    from one_class_ffm_torch.ops import kernels

    before = kernels.launch_counts()["topk_rows"]
    rec, lib, ids = serve_bench.run(device, **serve_bench.knobs())
    launches = kernels.launch_counts()["topk_rows"] - before
    print(f"[serve bench] {json.dumps(rec)}")
    print(f"[serve bench] library yardstick {json.dumps(lib)}")
    print(f"[serve bench] topk_rows launches {launches}")
    check(rec["value"] > 0 and ids is not None and int(ids.max()) <
          rec["catalog"], "serve bench: no ranking")
    if torch.device(device).type == "cuda":
        check(launches > 0, "serve bench: topk_rows never launched")


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


def cli_phase(device) -> None:
    """The command line on small text datasets: MF --ns, FFM, FM whose
    user field (5,050 features) is above the fused-table cap, and MF --ns
    with --blocked-bm 0 (both sides COO); then the predictor's command line
    on the FFM run's model, and MF --ns again under --profile-dir."""
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for tag, flags in (("mf", ["--ns"]),
                       ("ffm", ["-o", "model.txt", "--ckpt", "ck"]),
                       ("fm", []),
                       ("mf-coo", ["--ns", "--blocked-bm", "0"])):
        work = os.path.join(WORK, "cli_" + tag)
        os.makedirs(work, exist_ok=True)
        if tag == "fm":
            write_fm_dataset(work, SynthSpec(n_users=5000, n_items=300,
                                             avg_pos=6.0, seed=1))
        else:
            fields = 1 if tag.startswith("mf") else 2
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
    cli_predict(os.path.join(WORK, "cli_ffm"), env, device)
    cli_profile(os.path.join(WORK, "cli_mf"), env)


def cli_predict(work: str, env, device) -> None:
    """``python -m one_class_ffm_torch.predict`` with --scores on the test
    users of the FFM run (labeled rows, the popularity prior from its
    training file), from the text model and from the checkpoint: each must
    exit 0 and print the lines of the same call in this process."""
    from one_class_ffm_torch import predict
    from one_class_ffm_torch.data.dataset import read_data

    popular = read_data(os.path.join(work, "train.ffm"),
                        has_label=True).popular
    for source, args in (("text model", ["model.txt"]),
                         ("checkpoint", ["--ckpt", "ck"])):
        cmd = [sys.executable, "-m", "one_class_ffm_torch.predict", *args,
               "items.ffm", "va.ffm", "-k", "5", "--scores", "--labeled",
               "--popular-from", "train.ffm"]
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0,
              f"predict CLI ({source}) exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        paths = [os.path.join(work, a) for a in args if a != "--ckpt"]
        lay, k, params = predict.load_any_model(
            *((paths[0], None) if source == "text model"
              else (None, paths[0])))
        ids, scores = predict.predict_topk_from_model(
            lay, k, params, os.path.join(work, "items.ffm"),
            os.path.join(work, "va.ffm"), 5, popular=popular,
            with_scores=True, labeled=True, device=device)
        want = [",".join(f"{int(j)}:{scores[i][t]:.6g}"
                         for t, j in enumerate(row))
                for i, row in enumerate(ids)]
        got = proc.stdout.splitlines()
        print(f"[cli predict] {source}: exit 0, {len(got)} lines, first "
              f"{got[0] if got else None!r}; equal to the in-process "
              f"call's: {got == want}")
        check(got == want, f"predict CLI ({source}) printed other lines "
                           "than the in-process call")


def cli_profile(work: str, env) -> None:
    """``python -m one_class_ffm_torch --profile-dir`` on the small MF set:
    exit 0 and a Chrome trace under the directory holding CUDA kernel
    events."""
    import glob

    trace_dir = os.path.join(work, "trace")
    cmd = [sys.executable, "-m", "one_class_ffm_torch", "items.ffm",
           "train.ffm", "-p", "va.ffm", "--ns", "-k", "8", "-t", "2",
           "--eval-every", "2", "--profile-dir", trace_dir]
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"--profile-dir CLI exited "
                                f"{proc.returncode}: {proc.stderr[-2000:]}")
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"--profile-dir: trace files {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in kern})
    print(f"[cli profile] exit 0, {os.path.basename(files[0])}: "
          f"{len(events)} events, {len(kern)} CUDA kernel events of "
          f"{len(names)} kernels, e.g. {[n[:60] for n in names[:3]]}")
    check(kern, "--profile-dir: no CUDA kernel event in the trace")


def write_kkbox_raw(raw_dir: str, n: int = 500, seed: int = 0) -> None:
    """Tiny raw files of the Kaggle KKBox schema (train.csv, songs.csv,
    members.csv): 40 listeners, 25 songs, ``n`` plays."""
    import random

    rng = random.Random(seed)
    os.makedirs(raw_dir, exist_ok=True)
    users = [f"u{i}" for i in range(40)]
    songs = [f"s{i}" for i in range(25)]
    with open(os.path.join(raw_dir, "train.csv"), "w") as fh:
        fh.write("msno,song_id,source_system_tab,target\n")
        for _ in range(n):
            fh.write(f"{rng.choice(users)},{rng.choice(songs)},lib,"
                     f"{rng.randint(0, 1)}\n")
    with open(os.path.join(raw_dir, "songs.csv"), "w") as fh:
        fh.write("song_id,song_length,genre_ids,artist_name,language\n")
        for sid in songs:
            genres = "|".join(str(rng.randint(100, 105))
                              for _ in range(rng.randint(1, 2)))
            fh.write(f"{sid},200000,{genres},artist{rng.randint(1, 8)},"
                     f"{rng.choice([3, 17, 52])}\n")
    with open(os.path.join(raw_dir, "members.csv"), "w") as fh:
        fh.write("msno,city,bd,gender,registered_via\n")
        for u in users:
            fh.write(f"{u},{rng.randint(1, 5)},0,"
                     f"{rng.choice(['male', 'female', ''])},"
                     f"{rng.randint(3, 9)}\n")


def prep_phase(device, gpu: str) -> None:
    """``[prep]``: the port's KKBox pipeline (``prep/kkbox.py``: filter,
    encode, split) on tiny raw CSVs, then one epoch of the port's Trainer
    on the card on its FFM output (listeners x top songs)."""
    from one_class_ffm_torch.prep import kkbox
    from one_class_ffm_torch.train import TrainConfig, Trainer

    work = os.path.join(WORK, "prep_kkbox")
    raw, out = os.path.join(work, "raw"), os.path.join(work, "out")
    write_kkbox_raw(raw)
    t0 = time.perf_counter()
    check(kkbox.main(["all", "--raw", raw, "--out", out, "--threshold",
                      "2"]) == 0, "prep kkbox exited non-zero")
    prep_s = time.perf_counter() - t0
    files = sorted(f for f in os.listdir(out) if f.endswith(".ffm"))
    cfg = TrainConfig(item_path=os.path.join(out, "top_song.ffm"),
                      train_path=os.path.join(out, "listener.tr.ffm"),
                      test_path=os.path.join(out, "listener.va.ffm"), k=8,
                      nr_pass=1, eval_every=1, dtype="float32",
                      eval_chunk=64, row_multiple=8)
    tr = Trainer(cfg, device=device)
    tr.init_state()
    rows = []
    metrics = tr.run(log=rows.append)
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    check(metrics and not bad, f"prep: metrics {metrics}")
    d = tr.data
    print(f"[prep] kkbox: raw CSVs -> {files} in {prep_s:.2f} s; one epoch "
          f"on {tr.device} of {d.m_users_true} listeners x "
          f"{d.n_items_true} songs ({d.nnz_true} positives, fields "
          f"{list(d.u_pad.Ds)} x {list(d.v_pad.Ds)}): "
          f"{tr.history[-1]['seconds']:.4f} s, CG "
          f"{tr.history[-1]['cg_iters']}; row {rows[-1].strip()!r}; "
          f"auc {metrics['auc']:.4f} [{gpu}]")


BF16_EPOCHS = 11


def bf16_mf_phase(mf, device, gpu: str, nan_guard: bool = True) -> None:
    """``[bf16 mf]``: MF ``--ns`` at full width (200,000 x 20,000, k=32)
    trained 11 epochs at bf16 storage (``refresh_every`` 10, the bf16
    default) and at float32 from the same seed, AUC after each epoch side
    by side (ROADMAP C3: bf16 MF stays at AUC ~0.50 from 30,000 users on
    the card, as the JAX package's own bf16 does from 40,000 on the CPU).
    ``nan_guard`` False: train on past the divergence tripwire."""
    import dataclasses

    import torch

    aucs = {}
    for dt in ("float32", "bfloat16"):
        tr = make_trainer(mf, device, dtype=dt, epochs=1,
                          nan_guard=nan_guard)
        tr.init_state()
        aucs[dt] = []
        for ep in range(1, BF16_EPOCHS + 1):
            tr.cfg = dataclasses.replace(tr.cfg, nr_pass=ep)
            tr.run(log=lambda *_: None)
            aucs[dt].append(tr.validate()["auc"])
        print(f"[bf16 mf] {dt}: refresh_every {tr.refresh_every}, "
              f"{sum(h['seconds'] for h in tr.history):.3f} s for "
              f"{BF16_EPOCHS} epochs, objective "
              f"{float(tr.solver.objective(tr.state)):.6f}")
        del tr
        torch.cuda.empty_cache()
    for ep in range(BF16_EPOCHS):
        print(f"[bf16 mf] epoch {ep + 1}: AUC bf16 {aucs['bfloat16'][ep]:.4f}"
              f" f32 {aucs['float32'][ep]:.4f} [{gpu}]")
    check(all(math.isfinite(a) for v in aucs.values() for a in v),
          f"bf16 mf: non-finite AUC {aucs}")


# ---------------------------------------------------------------------------
# the meshes: ranks sharing the card over gloo
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_ROWS = 512  # row multiple: blocked_bm 256 x 2 data ranks, both sides
MESH_TOL = 1e-5  # max|delta| / max|ref|, float32: gradient and Hv
MESH_STEP_TOL = 1e-4  # the step: up to 20 CG iterations on those
MESH_OBJ_TOL = 1e-3  # relative, the objective after each epoch
MESH_MODEL_TOL = 0.0  # the 2x2 mesh's model file against the data mesh's
# a mesh's model file after 2 epochs against one process's, max|d|/max|ref|:
# at float32 a mesh rounds its row sums otherwise, and CG solves that stop
# unconverged (the categorical tables at or near the cap of 20) amplify that
# rounding.  Measured 1.51e-2 on the card (PR 15, and the half-solve trace
# of ``mesh_accuracy.py trace``); the JAX package's own 2-device mesh parts
# from its one device by the same order on the CPU
# (tests/test_torch_mesh_cap.py).  The gate is that distance plus a margin
# of about 3x for a change of rounding order elsewhere.
MESH_FILE_TOL = 5e-2
MESH_CHECK_USERS = 4096  # users whose gathered scores re-rank the top-K
# the problem of each mesh path: the headline FFM (``mesh_phase`` takes
# another, e.g. a toy size on the CPU); ``ref_shards``: the stream of the
# one-process reference (1: flat, else the ranks' shard-aligned stream, so
# that a COO side's stream-order carry and a head tier's chunks are the
# same on both); ``kernels``: the cases of ``mesh_cases`` and the kernels
# every rank's epochs must launch; ``trainer``: the Trainer's options;
# ``v_picks``: the cross blocks' v halves among the half-solves;
# ``model_file``: rank 0 writes the model after the epochs;
# ``model_ref``: the tag of the path whose rank-0 file it must equal;
# ``ckpt``: a sharded checkpoint after epoch 1, resumed to epoch 2
# (``ckpt_save`` / ``ckpt_resume``)
MESH_SPEC = dict(tag="mesh ffm", n_users=N_USERS, n_items=N_ITEMS,
                 dims=FFM_DIMS, rows=MESH_ROWS, mesh="2", ranks=2,
                 epochs=2, ref_shards=1, kernels="blocked", trainer={},
                 model_file=True)
MESH_PATHS = {
    "skew": dict(MESH_SPEC, tag="mesh ffm-skew", ref_shards=2,
                 kernels="skew", v_picks=True, model_file=False),
    "coo": dict(MESH_SPEC, tag="mesh ffm-coo", ref_shards=2, kernels="coo",
                trainer=dict(blocked_bm=0), v_picks=True, model_file=False),
    "2d": dict(MESH_SPEC, tag="mesh ffm-2d", mesh="2x2", ranks=4,
               ref_shards=2, model_ref="mesh ffm",
               trainer=dict(model_min_rows=4096), ckpt=True),
}
MESH_KERNELS = {"blocked": BLOCKED + TABLE + ("project",),
                "skew": BLOCKED + TABLE + ("project",),
                "coo": ("pos_scatter", "pos_seg_sum", "pos_hv_coo")
                + DOT + WIDE}


def reshard(data, rows: int, shards: int):
    """``data`` (a LoadedData) with both sides' rows padded to a multiple
    of ``rows`` (zero rows) and its stream rebuilt shard-aligned for
    ``shards`` data ranks (``pad_labels(shard_rows=)``): the arrays of one
    build laid out for a mesh, without drawing them again."""
    import dataclasses

    import numpy as np

    from one_class_ffm_torch.data.dataset import Interactions, pad_labels

    def pad(pf):
        extra = -(-pf.m // rows) * rows - pf.m
        return dataclasses.replace(
            pf, m=pf.m + extra,
            idx=tuple(np.pad(a, ((0, extra), (0, 0))) for a in pf.idx),
            val=tuple(np.pad(a, ((0, extra), (0, 0))) for a in pf.val),
            row_nnz=np.pad(pf.row_nnz, (0, extra)))

    u, v = pad(data.u_pad), pad(data.v_pad)
    y = data.y_pad
    real = y.w > 0
    uu, vv = y.u[real].astype(np.int64), y.v[real].astype(np.int64)
    indptr = np.zeros(data.m_users_true + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(uu, minlength=data.m_users_true))
    y2 = pad_labels(Interactions(m=data.m_users_true, n=data.n_items_true,
                                 indptr=indptr, col=vv),
                    u.m, v.m, nnz_multiple=rows * 8, dtype=np.float32,
                    shard_rows=u.m // shards)
    return dataclasses.replace(data, u_pad=u, v_pad=v, y_pad=y2)


def mesh_picks(solver, v_side: bool = False):
    """One cross half-solve on identity fields (B1-B3), one on a feature
    field (B4, B5, or a COO side's list and B8), one user and one item self
    block (B6, B7): (label, block index, first) for the identical-state
    comparison; with ``v_side`` the two cross blocks' v halves too (a
    power item's head chunks, a v-side list over the rank's items)."""
    meta = solver.meta
    blocks = meta.layout.all_blocks()
    picks = []
    for label, want, sides in (
            ("uv id", lambda b: b.kind == "uv" and meta.ident_u[b.fi]
             and meta.ident_v[b.fj], (True, False)),
            ("uv fused" if any(meta.fused_u) else "uv field",
             lambda b: b.kind == "uv" and not meta.ident_u[b.fi],
             (True, False)),
            ("uu", lambda b: b.kind == "uu", (True,)),
            ("vv", lambda b: b.kind == "vv", (True,))):
        i = next(i for i, b in enumerate(blocks) if want(b))
        for first in sides if v_side else (True,):
            picks.append((label if first else label + " v", i, first))
    return picks


def half_solve_outputs(solver, state, picks):
    """Per pick: the gradient, one Hv (of -G, the first CG direction) and
    the whole table after the step, as numpy, and the CG count."""
    sa, sb = solver.sasb(state)
    blocks = solver.meta.layout.all_blocks()
    out = {}
    for label, i, first in picks:
        b = blocks[i]
        G, hv, _, _, _ = solver.solve_inputs(state, b, first, sa, sb)
        Hv = hv((-G).to(solver.meta.dtype))
        st2, it = solver._solve_half(state, b, first, sa, sb)
        T = solver.full_params(st2["params"])[b.f12]["W" if first else "H"]
        _sync(solver.device)
        out[label] = dict(G=G.float().cpu().numpy(),
                          Hv=Hv.float().cpu().numpy(),
                          T=T.float().cpu().numpy(), iters=int(it))
    return out


def coo_sums(solver, state):
    """Each COO side's positive sums over its list (``pos_scatter`` of the
    first cross block's gradient coefficients), this process's rows, as
    numpy.  A rank's list holds the entries of its own rows in the one
    process's order, so its rows' sums are the one process's; the
    half-solves' gradients and Hv products also carry reductions over the
    other side's rows, whose float32 order a mesh changes."""
    from one_class_ffm_torch.ops.sparse_ops import pos_scatter

    b = solver.meta.layout.cross_blocks()[0]
    out = {}
    for first, s in ((True, "u"), (False, "v")):
        coo = solver._coo(first)
        if coo is None:
            continue
        B1 = solver._gather(state["Q" if first else "P"][b.f12], "check")
        c = solver._pos_coeff(state["yt_" + s]) * solver.data[f"blk_{s}_w"]
        out[s] = pos_scatter(c, B1, coo).float().cpu().numpy()
    return out


def _mesh_data(spec: dict, shards: int):
    """The problem of a mesh path: the pickled arrays at ``spec["data"]``
    (padded and shard-aligned by the parent) or the build of its sizes."""
    import pickle

    if spec.get("data"):
        with open(spec["data"], "rb") as fh:
            return pickle.load(fh)
    return build_data(spec["n_users"], spec["n_items"], 5.0, seed=0,
                      self_side=True, row_multiple=spec["rows"],
                      shards=shards, **spec["dims"])


def mesh_rank(state_path: str, picks, device: str, spec: dict):
    """One rank of a mesh path (spawned by ``mesh_phase``, in its own
    process, the group on gloo, the tensors on cuda:0 that the ranks
    share): the path's problem on its part of the rows through the Trainer
    with ``mesh_shape=spec["mesh"]``.  1. the half-solves of ``picks`` from
    the one-process state at ``state_path`` (numpy, cut to this rank's
    part by ``Trainer._place_state``); 2. ``spec["epochs"]`` epochs from
    the seed's tables with the launch counts and the census read around
    them, the census per epoch (with ``spec["model_file"]`` then rank 0
    writes its text model, ``Trainer.save_model``); validation by users,
    then by items; 3. the item-sharded ``predict_topk(k=10)``, and for its
    first users the top 10 of the ranks' gathered scores.  On the card
    first ``mesh_cases``: each kernel against its plain version on this
    rank's inputs (untimed: the ranks share the card).  Returns what the
    parent checks."""
    import dataclasses
    import io
    import pickle

    import torch

    from one_class_ffm_torch.evalx.torch_eval import (
        Evaluator,
        make_eval_data,
    )
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.predict import rank_topk
    from one_class_ffm_torch.train import TOP_KS

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * spec["ranks"])))
    epochs = spec["epochs"]
    t0 = time.perf_counter()
    n_data = int(spec["mesh"].split("x")[0])
    data = _mesh_data(spec, n_data)
    trainer = make_trainer(data, device, epochs=epochs,
                           mesh_shape=spec["mesh"], distributed=True,
                           eval_shard="users", **spec["trainer"])
    mesh, solver = trainer.mesh, trainer.solver
    d = solver.data
    out = dict(rank=mesh.rank, model_rank=mesh.model_rank,
               setup_s=time.perf_counter() - t0,
               rows=(solver.m_l, solver.n_l),
               u_blocks=(int(d["blk_u_own"].shape[0]) if "blk_u_own" in d
                         else 0),
               v_blocks=(int(d["blk_v_own"].shape[0]) if "blk_v_own" in d
                         else 0),
               stream=int(d["pos_w"].shape[0]), coo=coo_sides(solver),
               head={s: (int(d[f"blk_{s}_hd_rows"].numel()),
                         int((d[f"blk_{s}_hd_w"] != 0).any(dim=1).sum()),
                         int(d[f"blk_{s}_hd_w"].shape[0]))
                     for s in ("u", "v") if f"blk_{s}_hd_rows" in d},
               tables={f"{name}[{f12}]": tuple(t.shape)
                       for f12, blk in trainer.init_state()["params"].items()
                       for name, t in blk.items()})

    # 0. the kernels at this rank's shapes (the CPU runs the plain versions)
    report, lines = new_report(), io.StringIO()
    if device.type == "cuda":
        with contextlib.redirect_stdout(lines):
            kernel_phase(trainer, mesh_cases(trainer, spec["kernels"]),
                         f"{spec['tag']} rank {mesh.rank}.{mesh.model_rank}",
                         "", report, timed=False)
    out["kernel_lines"] = lines.getvalue().splitlines()
    out["kernel_errs"] = {name: r["max_abs_err"]
                          for name, r in report.items()}

    # 1. one identical state: the one-process state after its first epoch,
    # this rank's part of it
    with open(state_path, "rb") as fh:
        state1 = pickle.load(fh)
    state = trainer._place_state(state1)
    del state1
    out["coo_sums"] = coo_sums(solver, state)
    out["halves"] = half_solve_outputs(solver, state, picks)
    del state

    # 2. epochs from the seed's tables, validation by users
    kernels.reset_launch_counts()
    trainer.init_state()
    objectives = [float(solver.objective(trainer.state))]
    rows, census, seconds = [], [], []
    for ep in range(1, epochs + 1):
        trainer.cfg = dataclasses.replace(trainer.cfg, nr_pass=ep)
        mesh.census.reset()
        trainer.run(log=rows.append)
        census.append(mesh.census.rows())
        seconds.append(trainer.history[-1]["seconds"])
        objectives.append(float(solver.objective(trainer.state)))
        if spec.get("ckpt") and ep == 1:
            saved = ckpt_save(trainer, spec["ckpt_dir"], out)
    out["launches"] = kernels.launch_counts()
    if spec.get("ckpt"):
        unbroken = _local_tables(trainer.state)
    if spec.get("model_file"):  # every rank gathers, rank 0 writes
        trainer.save_model(spec["model_out"])
    out.update(objectives=objectives, census=census, seconds=seconds,
               iters=[h["cg_iters"] for h in trainer.history],
               rows_logged=rows,
               model=(spec["model_out"] if spec.get("model_file")
                      and trainer.is_writer else None),
               validate_s=trainer.timer.summary()["validate"]["seconds"])
    st = trainer.state
    params = trainer.full_params()
    out["metrics_users"] = trainer.validate()

    # validation by items: every rank the same users, its items
    d = trainer.data
    emeta, edata = make_eval_data(
        d.uva_pad, d.va_labels, d.popular, n_items=d.v_pad.m,
        n_items_true=d.n_items_true, layout=d.layout, dtype=trainer.dtype,
        top_ks=TOP_KS, device=device)
    ev_items = Evaluator(emeta, edata, chunk=trainer.cfg.eval_chunk
                         ).shard_items(mesh)
    _sync(device)
    t0 = time.perf_counter()
    out["metrics_items"] = ev_items.validate(params, st["Q"], st["b"])
    out["validate_items_s"] = time.perf_counter() - t0

    # 3. the item-sharded top 10, and its first users re-ranked from the
    # ranks' gathered scores
    trainer.evaluator = ev_items
    t0 = time.perf_counter()
    ids = trainer.predict_topk(k=10)
    out["predict_s"] = time.perf_counter() - t0
    out["ids_shape"] = ids.shape
    Pva, _ = ev_items._project_users(params)
    f12s = [b.f12 for b in emeta.layout.cross_blocks()]
    n_local = emeta.n // mesh.size
    gid = mesh.rank * n_local + torch.arange(n_local, device=device)
    same = 0
    users = min(MESH_CHECK_USERS, emeta.mt_true)
    for lo in range(0, users, 1024):
        sl = slice(lo, min(lo + 1024, users))
        z = st["b"][None, :].expand(sl.stop - sl.start, n_local)
        for f12 in sorted(f12s):
            z = z + Pva[f12][sl] @ st["Q"][f12].T
        z = torch.where(ev_items.data["cold"][sl][:, None],
                        ev_items.data["popular"][None, :], z)
        z = torch.where((gid < emeta.catalog)[None, :], z,
                        torch.full_like(z, torch.finfo(z.dtype).min))
        full = mesh.all_gather(z, "check", dim=1)
        ref = rank_topk(full, 10)[1].cpu().numpy()
        same += int((ref == ids[sl]).all(axis=1).sum())
    out["ids_same"], out["ids_checked"] = same, users
    if spec.get("ckpt"):
        ckpt_resume(trainer, spec["ckpt_dir"], saved, unbroken, out)
    return out


def _local_tables(state):
    """Copies of the tables as this rank's state holds them."""
    return {f12: {n: t.clone() for n, t in blk.items()}
            for f12, blk in state["params"].items()}


def _max_diff(a, b) -> float:
    return max(float((a[f12][n].double() - b[f12][n].double()).abs().max())
               for f12 in a for n in a[f12])


def _max_rel(a, b):
    """(max|d|/max|ref|, name) of the worst table of ``a`` against ``b``."""
    return max((float((a[f12][n].double() - b[f12][n].double()).abs().max())
                / (float(b[f12][n].abs().max()) or 1.0), f"{n}[{f12}]")
               for f12 in a for n in a[f12])


def ckpt_save(trainer, path: str, out: dict):
    """A sharded checkpoint of this rank's state (``--ckpt-format orbax``,
    ``utils.sharded_ckpt``) with the mesh's census read around the save,
    then the same save again into ``path + "_warm"``; into ``out`` the
    seconds of importing DCP and DTensor (once a process), the census of
    both saves, the bytes this rank wrote, the seconds of each, the
    tables' specs and on world rank 0 the whole tables (gathered after
    the saves).  Returns this rank's tables."""
    import dataclasses

    import torch

    from one_class_ffm_torch.solver.convert import params_to_numpy

    mesh = trainer.mesh
    # the one-time import of DTensor and DCP (op registrations, sympy)
    # timed apart from the save
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401
    import torch.distributed.tensor  # noqa: F401
    out["ckpt_import_s"] = time.perf_counter() - t0
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=path,
                                      ckpt_format="orbax")
    mesh.census.reset()
    trainer.save_checkpoint()
    out["ckpt_save"] = trainer.ckpt_stats[-1]
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=path + "_warm")
    trainer.save_checkpoint()
    out["ckpt_census"] = mesh.census.rows()
    out["ckpt_save_warm"] = trainer.ckpt_stats[-1]
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=None)
    out["ckpt_specs"] = trainer.solver.table_specs()
    out["world_rank"] = torch.distributed.get_rank()
    held = _local_tables(trainer.state)
    whole = params_to_numpy(trainer.full_params())
    out["ckpt_whole"] = whole if out["world_rank"] == 0 else None
    return held


def ckpt_resume(trainer, path: str, saved, unbroken, out: dict) -> None:
    """The checkpoint of ``ckpt_save`` restored onto this rank (its own
    rows of each model-sharded table) and trained on to epoch 2.  A restore
    re-derives the caches from the tables, as the JAX package's
    ``load_checkpoint`` does: the resumed epoch is held bit for bit to the
    same epoch run from the saved tables with the caches re-derived in
    place (``refresh_caches``); against the unbroken run, whose caches
    were carried, its objective and its tables' distance (float32
    roundings that CG solves at the cap amplify, ROADMAP C1)."""
    import dataclasses

    solver = trainer.solver
    state = solver.refresh_caches({"params": saved})
    refreshed = _local_tables(solver.epoch_stats(state)[0])
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=path,
                                      ckpt_format="orbax", nr_pass=2)
    trainer.load_checkpoint()
    out["ckpt_load"] = trainer.ckpt_stats[-1]
    out["ckpt_loaded_diff"] = _max_diff(_local_tables(trainer.state), saved)
    trainer.cfg = dataclasses.replace(trainer.cfg, ckpt_dir=None)
    trainer.run(log=lambda *_: None)
    resumed = _local_tables(trainer.state)
    out["ckpt_resumed_diff"] = _max_diff(resumed, refreshed)
    out["ckpt_unbroken_rel"] = _max_rel(resumed, unbroken)
    out["ckpt_objective"] = float(solver.objective(trainer.state))


def ckpt_files(path: str, specs, model_of) -> dict:
    """From DCP's metadata of the step directory under ``path``: per
    table the row blocks and the world rank that wrote each; fails unless
    each row block of a model-sharded table was written by a rank of its
    model index, once, and a replicated table once whole."""
    from torch.distributed.checkpoint import FileSystemReader

    from one_class_ffm_torch.utils import sharded_ckpt

    step = sharded_ckpt.read_meta(path)["step_dir"]
    md = FileSystemReader(os.path.join(path, step)).read_metadata()
    files = {}
    for f12, blk in specs.items():
        for name, (rows, sharded) in blk.items():
            key = f"{f12}.{name}"
            blocks = []
            for c in md.state_dict_metadata[key].chunks:
                idx = next(i for i in md.storage_data if i.fqn == key
                           and tuple(i.offset) == tuple(c.offsets))
                writer = int(md.storage_data[idx].relative_path.split("_")[2])
                blocks.append((int(c.offsets[0]), int(c.sizes[0]), writer))
            parts = len(set(model_of.values())) if sharded else 1
            check(sorted(b[0] for b in blocks)
                  == [i * rows // parts for i in range(parts)]
                  and all(n == rows // parts for _, n, _ in blocks),
                  f"checkpoint: {key}'s row blocks {blocks} for {rows} "
                  f"rows, {'sharded' if sharded else 'replicated'}")
            if sharded:
                check(all(model_of[w] * rows // parts == lo
                          for lo, _, w in blocks),
                      f"checkpoint: {key}'s row blocks {blocks} written by "
                      f"ranks of other model indices ({model_of})")
            files[f"{name}[{f12}]"] = blocks
    return files


def mesh_phase(device, gpu: str, report, spec: dict = MESH_SPEC):
    """``[mesh ffm]`` and the other mesh paths (``MESH_PATHS``): the
    path's problem at full width on ``spec["ranks"]`` ranks
    (``spec["mesh"]``: ``"2"``, or ``"2x2"`` data x model) that share the
    one card over gloo (NCCL runs one rank per card; the timing is not a
    scaling number).  The parent runs the one-process reference on the
    same padding, hands its state after one epoch to the ranks, spawns
    them (``parallel.distributed.spawn``: a rank that fails fails the run)
    and checks: the half-solves against the one-process path
    (``MESH_TOL``, the step ``MESH_STEP_TOL``), the objective after each
    epoch (``MESH_OBJ_TOL``), finite metrics by users and by items, the
    merged top-10 against the gathered scores' bit for bit, the census (in
    CG one all-reduce per Hv, no all-gather), with ``spec["model_file"]``
    rank 0's model file after the epochs (true dims) within
    ``MESH_FILE_TOL`` of the one process's and, with ``spec["model_ref"]``,
    equal to that path's
    rank-0 file (``MESH_MODEL_TOL``), and on the card each kernel of the
    path held against its plain version on each rank's inputs
    (``mesh_cases``; its error goes into ``report``) and launched on each
    rank.  Returns the launch counts summed over the ranks."""
    import pickle

    import numpy as np

    from one_class_ffm_torch.parallel.distributed import spawn
    from one_class_ffm_torch.parallel.mesh import host_arrays
    from one_class_ffm_torch.train import load_text_model, save_text_model

    tag = spec["tag"]
    t0 = time.perf_counter()
    data = _mesh_data(spec, spec["ref_shards"])
    ref = make_trainer(data, device, epochs=spec["epochs"], **{
        k: v for k, v in spec["trainer"].items() if k != "model_min_rows"})
    solver = ref.solver
    state = ref.init_state()
    state1, _ = solver.epoch_stats(state)
    picks = mesh_picks(solver, spec.get("v_picks", False))
    ref_halves = half_solve_outputs(solver, state1, picks)
    ref_sums = coo_sums(solver, state1)
    work = os.path.join(WORK, tag.replace(" ", "_"))
    os.makedirs(work, exist_ok=True)
    state_path = os.path.join(work, "state1.pkl")
    with open(state_path, "wb") as fh:
        pickle.dump(host_arrays(state1), fh, protocol=4)
    params1 = state1["params"]
    del state1
    single = train_and_validate(ref, spec["epochs"])
    if spec.get("ckpt"):  # the same 2 epochs, the caches re-derived after 1
        st = solver.epoch_stats(solver.refresh_caches({"params": params1}))[0]
        spec = dict(spec, one_refresh=(
            *_max_rel(st["params"], ref.state["params"]),
            float(solver.objective(st)), single["objectives"][2]))
        del st
    del params1
    ref_model = os.path.join(work, "one_process.txt")
    if spec.get("model_file"):
        save_text_model(ref_model, ref.params_numpy(), data.layout,
                        ref.cfg.k)
    stream = "flat" if spec["ref_shards"] == 1 else "shard-aligned"
    print(f"[{tag}] one-process reference (rows to {spec['rows']}, {stream} "
          f"stream, COO sides {coo_sides(solver)}): "
          f"{time.perf_counter() - t0:.1f} s; {spec['ranks']} ranks "
          f"(--mesh {spec['mesh']}) on {device} over gloo: ranks sharing "
          f"one card, not a scaling number [{gpu}]")
    t0 = time.perf_counter()
    spec = dict(spec, model_out=os.path.join(work, "rank0.txt"),
                ckpt_dir=os.path.join(work, "ckpt"))
    for old in (spec["ckpt_dir"], spec["ckpt_dir"] + "_warm"):
        if os.path.isdir(old):
            import shutil

            shutil.rmtree(old)
    outs = spawn("chip_smoke:mesh_rank", spec["ranks"],
                 args=(state_path, picks, str(device), spec),
                 backend="gloo", workdir=work, timeout=900)
    print(f"[{tag}] {spec['ranks']} ranks done in "
          f"{time.perf_counter() - t0:.1f} s (each: process start, data, "
          f"layouts, the checks below)")
    names = MESH_KERNELS[spec["kernels"]]
    launches = {name: 0 for name in REPLACES}
    for o in outs:
        r = f"{o['rank']}.{o['model_rank']}" if "x" in spec["mesh"] \
            else o["rank"]
        print(f"[{tag}] rank {r}: rows u {o['rows'][0]} v {o['rows'][1]}, "
              f"blocks u {o['u_blocks']} v {o['v_blocks']}, stream slice "
              f"{o['stream']}, COO sides {o['coo']}, head tier (rows, real "
              f"chunks, chunks) {o['head']}; set-up {o['setup_s']:.1f} s")
        if "x" in spec["mesh"]:
            print(f"[{tag}] rank {r} tables held: {o['tables']}")
        for line in o["kernel_lines"]:
            print(line)
        held = {line.split()[1] for line in o["kernel_lines"]
                if "bit-equal" in line}
        for name in names if device.type == "cuda" else ():
            check(name in held, f"{name} not held against its plain version "
                                f"on {tag} rank {r}")
        for name, err in o["kernel_errs"].items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              err)
        for s, got in o["coo_sums"].items():
            rows = got.shape[0]
            want = ref_sums[s][o["rank"] * rows:(o["rank"] + 1) * rows]
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max()) or 1.0
            print(f"[{tag}] rank {r} the {s} side's list sums ({rows} rows): "
                  f"max-abs against the one process's rows {err:.3e}")
            check(err / scale <= MESH_TOL,
                  f"{tag} rank {r}: the {s} side's list sums off by {err}")
        for label, got in o["halves"].items():
            want = ref_halves[label]
            errs = {}
            for key in ("G", "Hv", "T"):
                scale = float(np.abs(want[key]).max()) or 1.0
                errs[key] = float(np.abs(got[key] - want[key]).max()) / scale
            print(f"[{tag}] rank {r} half-solve {label}: max|d|/max|ref| "
                  f"gradient {errs['G']:.3e}, Hv {errs['Hv']:.3e}, step "
                  f"{errs['T']:.3e}; CG {got['iters']} vs one process "
                  f"{want['iters']}")
            check(errs["G"] <= MESH_TOL and errs["Hv"] <= MESH_TOL,
                  f"{tag} rank {r} {label}: gradient / Hv off the "
                  f"one-process path by {errs}")
            check(errs["T"] <= MESH_STEP_TOL
                  and got["iters"] == want["iters"],
                  f"{tag} rank {r} {label}: step off by {errs['T']}, CG "
                  f"{got['iters']} vs {want['iters']}")
        for i, (sec, it) in enumerate(zip(o["seconds"], o["iters"])):
            obj, ref_obj = o["objectives"][i + 1], single["objectives"][i + 1]
            print(f"[{tag}] rank {r} epoch {i + 1}: {sec:.4f} s "
                  f"({spec['ranks']} ranks sharing one card: not a scaling "
                  f"number), CG {it}, objective {obj:.6f} vs one process "
                  f"{ref_obj:.6f} (CG {single['iters'][i]}) [{gpu}]")
            check(abs(obj - ref_obj) <= MESH_OBJ_TOL * abs(ref_obj),
                  f"{tag} rank {r} epoch {i + 1}: objective {obj} vs "
                  f"{ref_obj}")
            cen = o["census"][i]
            in_cg = {(op, site): c for op, site, sc, c, _ in cen
                     if sc == "cg"}
            check(in_cg == {("all_reduce", "hv"): sum(it)},
                  f"{tag} rank {r} epoch {i + 1}: collectives in CG "
                  f"{in_cg}, CG iterations {sum(it)}")
            print(f"[{tag}] rank {r} epoch {i + 1} census (op, site, "
                  f"scope: calls, bytes): " + "; ".join(
                      f"{op} {site} {sc}: {c}, {b}"
                      for op, site, sc, c, b in cen))
        for by in ("users", "items"):
            m = o[f"metrics_{by}"]
            bad = {k: v for k, v in m.items() if not math.isfinite(v)}
            check(not bad, f"{tag} rank {r}: non-finite metrics {bad}")
            print(f"[{tag}] rank {r} validation by {by}: "
                  f"{json.dumps(m)}")
        print(f"[{tag}] one-process validation: "
              f"{json.dumps(single['metrics'])}")
        print(f"[{tag}] rank {r} validation s: by users "
              f"{o['validate_s']:.4f}, by items {o['validate_items_s']:.4f}; "
              f"item-sharded predict_topk(k=10) {o['predict_s']:.4f} s, ids "
              f"{tuple(o['ids_shape'])}, the first {o['ids_checked']} users "
              f"equal to the gathered scores' top 10: {o['ids_same']} "
              f"[{gpu}]")
        check(o["ids_same"] == o["ids_checked"],
              f"{tag} rank {r}: merged top-10 ids differ from the "
              f"gathered scores' on {o['ids_checked'] - o['ids_same']} users")
        check(tuple(o["ids_shape"]) == (len(data.va_labels), 10),
              f"{tag} rank {r}: top-K shape {o['ids_shape']}")
        print(f"[{tag}] rank {r} kernel launches {o['launches']} (the "
              f"X^T stage runs inside each B4-B7 launch)")
        for name in names if device.type == "cuda" else ():
            check(o["launches"][name] > 0,
                  f"{name} never launched on {tag} rank {r}")
        for name in REPLACES:
            launches[name] += o["launches"][name]
        if o["model"]:
            _, k_m, p_m = load_text_model(o["model"])
            refs = [("the one process's", ref_model, MESH_FILE_TOL)]
            if spec.get("model_ref"):
                refs.append((f"[{spec['model_ref']}] rank 0's",
                             os.path.join(WORK, spec["model_ref"].replace(
                                 " ", "_"), "rank0.txt"), MESH_MODEL_TOL))
            for what, path, tol in refs:
                _, k_r, p_r = load_text_model(path)
                dims = {f"{n}[{f12}]": (p_m[f12][n].shape, blk[n].shape)
                        for f12, blk in p_r.items() for n in ("W", "H")}
                check(k_m == k_r and all(a == b for a, b in dims.values()),
                      f"{tag}: model file dims {dims} against {what}")
                err = max(float(np.abs(p_m[f12][n] - blk[n]).max())
                          / (float(np.abs(blk[n]).max()) or 1.0)
                          for f12, blk in p_r.items() for n in ("W", "H"))
                print(f"[{tag}] rank {r} model file after epoch "
                      f"{spec['epochs']}: k {k_m}, tables (rows, k) "
                      f"{ {key: a for key, (a, _) in dims.items()} }, "
                      f"max|d|/max|ref| against {what} file {err:.3e}")
                check(err <= tol, f"{tag}: model file off {what} by {err} "
                                  f"(gate {tol})")
    check(all(o["iters"] == outs[0]["iters"] for o in outs),
          f"{tag}: the ranks' CG counts differ")
    check(any(o["model"] for o in outs) == bool(spec.get("model_file")),
          f"{tag}: rank 0 wrote no model file")
    if spec.get("ckpt"):
        ckpt_checks(tag, spec, outs, gpu)
    return launches


def ckpt_checks(tag: str, spec: dict, outs, gpu: str) -> None:
    """The sharded checkpoint of a mesh path (``ckpt_save`` after epoch 1,
    ``ckpt_resume`` to epoch 2 on each rank): each rank's bytes written and
    save and load seconds; no model-axis all-gather in the census of the
    save; each row block of a model-sharded table written once, by a rank
    of its model index (``ckpt_files``); the restore equal to the saved
    tables and the resumed epoch to the refreshed one bit for bit; the
    resumed objective within ``MESH_OBJ_TOL`` of the unbroken run's, its
    tables' distance beside the one process's when it re-derives its
    caches after epoch 1 likewise; a one-process restore (no mesh) equal
    to the mesh's whole tables bit for bit."""
    import numpy as np

    from one_class_ffm_torch.utils import sharded_ckpt

    path = spec["ckpt_dir"]
    specs = outs[0]["ckpt_specs"]
    total = 0
    for o in outs:
        r = f"{o['rank']}.{o['model_rank']}"
        sv, ld = o["ckpt_save"], o["ckpt_load"]
        total += sv["bytes"]
        gathers = [row for row in o["ckpt_census"]
                   if row[0] == "all_gather@model"]
        obj, ref_obj = o["ckpt_objective"], o["objectives"][2]
        one = spec["one_refresh"]
        print(f"[{tag}] rank {r} sharded checkpoint after epoch 1: "
              f"{sv['bytes']} bytes written, save {sv['seconds']:.4f} s "
              f"(the process's first; before it the import of DCP and "
              f"DTensor {o['ckpt_import_s']:.4f} s, the DeviceMesh "
              f"{sv['mesh_seconds']:.4f} s), again "
              f"{o['ckpt_save_warm']['seconds']:.4f} s, load "
              f"{ld['seconds']:.4f} s; census of both saves "
              f"{o['ckpt_census']}; restore vs saved max|d| "
              f"{o['ckpt_loaded_diff']:.3e}, resumed epoch 2 vs the same "
              f"epoch from the saved tables (caches re-derived) max|d| "
              f"{o['ckpt_resumed_diff']:.3e}; vs the unbroken run: "
              f"objective {obj:.6f} / {ref_obj:.6f}, worst table "
              f"max|d|/max|ref| {o['ckpt_unbroken_rel'][0]:.3e} "
              f"({o['ckpt_unbroken_rel'][1]}); one process, caches "
              f"re-derived after epoch 1 likewise: objective {one[2]:.6f} / "
              f"{one[3]:.6f}, worst table {one[0]:.3e} ({one[1]}) [{gpu}]")
        check(not gathers, f"{tag} rank {r}: the save gathered over the "
                           f"model axis: {gathers}")
        check(o["ckpt_loaded_diff"] == 0.0 and o["ckpt_resumed_diff"] == 0.0,
              f"{tag} rank {r}: restore off by {o['ckpt_loaded_diff']}, "
              f"resumed epoch off by {o['ckpt_resumed_diff']}")
        check(abs(obj - ref_obj) <= MESH_OBJ_TOL * abs(ref_obj),
              f"{tag} rank {r}: resumed objective {obj} vs the unbroken "
              f"run's {ref_obj}")
    model_of = {o["world_rank"]: o["model_rank"] for o in outs}
    files = ckpt_files(path, specs, model_of)
    ref = next(o["ckpt_whole"] for o in outs if o["ckpt_whole"] is not None)
    whole = sum(a.nbytes for blk in ref.values() for a in blk.values())
    print(f"[{tag}] checkpoint row blocks (first row, rows, world rank that "
          f"wrote it) {files}; bytes written by the ranks together {total}, "
          f"the whole tables {whole}")
    t0 = time.perf_counter()
    tables, epoch = sharded_ckpt.load(path)
    load_s = time.perf_counter() - t0
    diff = 0.0
    for f12, blk in ref.items():
        for name, want in blk.items():
            got = tables[f12][name].float().numpy()
            check(got.shape[0] >= want.shape[0] and not np.any(
                got[want.shape[0]:]), f"{tag}: one-process restore of "
                                      f"{name}[{f12}]: pad rows not zero")
            diff = max(diff, float(np.abs(got[: want.shape[0]] - want).max()))
    print(f"[{tag}] one-process restore (no mesh) of the checkpoint: epoch "
          f"{epoch}, {load_s:.4f} s, max|d| against the mesh's whole tables "
          f"{diff:.3e} [{gpu}]")
    check(epoch == 1 and diff == 0.0,
          f"{tag}: one-process restore at epoch {epoch} off by {diff}")


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

        # 2. build; beside the kernels the native text parser and model
        # reader (native/parser.cpp), with which the serving phase writes
        # and reads a full-width text model
        from one_class_ffm_torch.ops import kernels
        from one_class_ffm_torch.ops.layout import feature_major

        native = subprocess.Popen(["make", "-C",
                                   os.path.join(ROOT, "native")],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        try:
            kernels.load()
            made = native.communicate(timeout=600)[0]
        finally:
            if native.poll() is None:
                native.kill()
                native.wait()
        check(native.returncode == 0, f"make -C native: {made[-2000:]}")
        print(f"[build] {kernels.library_path().name} in "
              f"{kernels.build_seconds:.2f} s; native/libocffm.so (make "
              f"exit 0)")
        regs = kernel_registers(str(kernels.library_path()))
        _REGS.update(regs or {})
        for (kname, dt_name, diag, targs), (n, shared, stack) in sorted(
                (regs or {}).items()):
            plan = f"<{','.join(map(str, targs))}>" if targs else ""
            print(f"[build] {kname}{plan}{' (Jacobi)' if diag else ''} "
                  f"{dt_name}: {n} registers per thread, {shared} bytes of "
                  f"static shared memory, {stack} bytes of stack")
        if regs is None:
            print("[build] registers per thread: not measured (no "
                  "cuobjdump)")

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
        t0 = time.perf_counter()
        skew = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                          pop_skew=1.0, **FFM_DIMS)
        top = int(skew.y_pad.count_v.max())
        print(f"[data] FFM skew {skew.u_pad.Ds} x {skew.v_pad.Ds}, item "
              f"popularity zipf 1.0 (build_padded, bench.py BENCH_SKEW=1): "
              f"{skew.nnz_true} training positives, {len(skew.va_labels)} "
              f"test users, the top item {top} positives; "
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
        ffm_jac = make_trainer(ffm, device, cg_precond="jacobi")
        fm_jac = make_trainer(fm, device, cg_precond="jacobi")
        t0 = time.perf_counter()
        skew_trainer = make_trainer(skew, device)
        print(f"[data] FFM skew trainer (two-tier layouts, device data, "
              f"evaluator) in {time.perf_counter() - t0:.2f} s")
        check(skew_trainer.solver.hd_v,
              "FFM skew: the v side took no head tier")
        # the plain COO positive passes: the FFM with both sides COO, and
        # the skewed FFM without the head tier (its v side COO) under Jacobi
        t0 = time.perf_counter()
        coo_trainer = make_trainer(ffm, device, blocked_bm=0)
        skew_coo = make_trainer(skew, device, cg_precond="jacobi",
                                head_chunk=0)
        print(f"[data] FFM coo and FFM skew-coo trainers (lists of the "
              f"stream, device data, evaluators) in "
              f"{time.perf_counter() - t0:.2f} s")
        for tag, tr, want in (("FFM coo", coo_trainer, "u and v"),
                              ("FFM skew-coo", skew_coo, "v")):
            got = coo_sides(tr.solver)
            check(got == want, f"{tag}: COO sides {got}, not {want}")
            meta = tr.solver.meta
            print(f"[data] {tag}: COO sides {got}; blocked_bm u "
                  f"{meta.blocked_bm_u} v {meta.blocked_bm_v}; fused fields "
                  f"u {meta.fused_u} v {meta.fused_v}")
        meta = fm_trainer.solver.meta
        check(not any(meta.fused_u + meta.fused_v + meta.ident_u
                      + meta.ident_v),
              "FM: a field is identity or takes the fused table passes")
        for tag, tr in (("MF", mf_trainer), ("FFM", ffm_trainer),
                        ("FM", fm_trainer), ("FFM skew", skew_trainer),
                        ("FFM coo", coo_trainer),
                        ("FFM skew-coo", skew_coo)):
            print_static_plan(tag, tr.solver.data)
        kernel_phase(mf_trainer, mf_cases(mf_trainer), "MF", gpu, report)
        # the CG recurrence on the MF solves' vectors (200,000 x 32 and
        # 20,000 x 32), and under Jacobi on the FFM's categorical cross
        # solves (fused fields, D=1000 / 500), compared only
        cg_phase(mf_trainer, mf_trainer.solver.meta.layout.cross_blocks()[0],
                 (True, False), "MF", gpu, report)
        jb = {(x.f1, x.f2): x for x in ffm_jac.solver.meta.layout.all_blocks()}
        cg_phase(ffm_jac, jb[(1, ffm_jac.solver.meta.layout.fu + 1)],
                 (True, False), "FFM jacobi", gpu, report, timed=False)
        variant_phase(mf_trainer, gpu, report)
        kernel_phase(ffm_trainer, ffm_cases(ffm_trainer), "FFM", gpu, report)
        kernel_phase(fm_trainer, fm_cases(fm_trainer), "FM", gpu, report)
        kernel_phase(ffm_jac, jacobi_cases(ffm_jac), "FFM jacobi", gpu,
                     report)
        # the skewed FFM's tail streams: held like the others, timed
        # apart (the JSON's times stay those of the shapes above)
        skew_report = new_report()
        kernel_phase(skew_trainer, skew_cases(skew_trainer), "FFM skew",
                     gpu, skew_report)
        for name, r in skew_report.items():
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              r["max_abs_err"])
        # the COO passes at both COO paths' shapes (their JSON times sum
        # over these sides and shapes)
        kernel_phase(coo_trainer, coo_cases(coo_trainer), "FFM coo", gpu,
                     report)
        kernel_phase(skew_coo, skew_coo_cases(skew_coo), "FFM skew-coo",
                     gpu, report)
        topk_phase(device, gpu, report)

        # 4. small-input references
        for tag in ("MF", "FFM", "FM", "skew", "coo", "mixed"):
            reference_phase(device, tag)
        for tag in ("FFM", "FM", "skew", "coo", "mixed"):
            reference_phase(device, tag, cg_precond="jacobi")

        # 5.-7. the main paths at full width, each with its own counts
        launches = {name: 0 for name in REPLACES}
        jac_blocked = ("pos_hv_blocked", "pos_gap_blocked",
                       "pos_scatter_blocked_diag")
        results = {}
        for tag, trainer, names in (
                ("mf", mf_trainer, BLOCKED + ("project",)),
                # pos_dot: the residual refresh (init_state)
                ("ffm", ffm_trainer, BLOCKED + TABLE + ("project",) + DOT),
                ("fm", fm_trainer, BLOCKED + WIDE),
                ("ffm-jacobi", ffm_jac, jac_blocked + (
                    "pos_hv_tbl", "hv_self_tbl", "grad_cross_tbl_diag",
                    "grad_self_tbl_diag", "project")),
                ("fm-jacobi", fm_jac, jac_blocked + WIDE),
                ("ffm-skew", skew_trainer, BLOCKED + TABLE + ("project",)),
                # both sides COO: every field off the fused passes
                ("ffm-coo", coo_trainer,
                 ("pos_scatter", "pos_seg_sum", "pos_hv_coo") + DOT + WIDE),
                # v COO under Jacobi, u blocked (its fused field too); the
                # gradient's pair in place of pos_scatter
                ("ffm-skew-coo", skew_coo, (
                    "pos_scatter_pair", "pos_seg_sum", "pos_hv_coo") + DOT
                 + WIDE + jac_blocked + (
                    "pos_hv_tbl", "hv_self_tbl", "grad_cross_tbl_diag",
                    "grad_self_tbl_diag"))):
            if tag.endswith("coo"):
                print(f"[main {tag}] COO sides: {coo_sides(trainer.solver)}")
            got, results[tag] = main_path(tag, trainer, names + CG, gpu)
            for name in REPLACES:
                launches[name] += got[name]
            results[tag]["loops"] = loop_check(tag, trainer, gpu)
        check(not any(results["ffm-coo"]["launches"][name]
                      for name in BLOCKED + TABLE + DIAG),
              "ffm-coo: a blocked or fused kernel launched with both sides "
              "COO")
        check_repeatable("ffm-skew", skew_trainer)
        check_repeatable("ffm-coo", coo_trainer)
        check_repeatable("ffm-skew-coo", skew_coo)
        head_op_phase(skew_trainer, gpu)
        for tag in ("ffm", "fm"):
            plain, jac = results[tag], results[tag + "-jacobi"]
            for i, (ip, ij) in enumerate(zip(plain["iters"], jac["iters"])):
                print(f"[main {tag}-jacobi] epoch {i + 1}: CG iterations "
                      f"per solve, jacobi {ij} (sum {sum(ij)}, "
                      f"{jac['seconds'][i]:.4f} s) vs plain CG {ip} (sum "
                      f"{sum(ip)}, {plain['seconds'][i]:.4f} s) [{gpu}]")

        # 8. the serving path on the headline FFM the main path trained
        for got in (serve_phase(ffm_trainer, device, gpu),
                    entry_phase(device, gpu)):
            for name in REPLACES:
                launches[name] += got[name]
        serve_bench_phase(device, gpu)

        # 9. the Hv variants' path: the comparison of hv_pack_bench
        from one_class_ffm_torch import hv_pack_bench

        kernels.reset_launch_counts()
        rc = hv_pack_bench.main([])
        got = kernels.launch_counts()
        print(f"[hv_pack_bench] exit {rc}, kernel launches "
              f"{ {name: got[name] for name in VARIANTS} }")
        check(rc == 0, "hv_pack_bench: a variant is not B1's bits")
        for name in VARIANTS:
            check(got[name] > 0, f"{name} never launched in hv_pack_bench")
            launches[name] += got[name]

        # 10. the meshes: the headline FFM on 2 data ranks sharing the
        # card, then the skewed FFM (head tier under the mesh; the arrays
        # of phase 3, padded and shard-aligned), the FFM with both sides
        # COO, and the FFM on the 2x2 data x model mesh
        import pickle

        os.makedirs(WORK, exist_ok=True)
        skew_path = os.path.join(WORK, "skew_mesh.pkl")
        with open(skew_path, "wb") as fh:
            pickle.dump(reshard(skew, MESH_ROWS, MESH_RANKS), fh, protocol=4)
        # each phase from here on runs even when an earlier one failed (the
        # 2x2 mesh reads [mesh ffm]'s file, written before its checks); a
        # failure is reported after the last, and the run fails
        late = []

        def late_phase(tag: str, fn) -> None:
            try:
                fn()
            except Exception as e:  # reported below; the run fails
                print(f"[{tag}] FAIL: {type(e).__name__}: {e}", flush=True)
                late.append(f"{tag}: {type(e).__name__}: {e}")

        def mesh(spec) -> None:
            got = mesh_phase(device, gpu, report, spec)
            for name in REPLACES:
                launches[name] += got[name]

        for spec in (MESH_SPEC, dict(MESH_PATHS["skew"], data=skew_path),
                     MESH_PATHS["coo"], MESH_PATHS["2d"]):
            late_phase(spec["tag"], lambda: mesh(spec))

        # 11. the command-line entry points
        late_phase("cli", lambda: cli_phase(device))

        # 12. the raw-data pipeline's output trained on the card, and bf16
        # MF's AUC beside f32's over 11 epochs
        late_phase("prep", lambda: prep_phase(device, gpu))
        late_phase("bf16 mf", lambda: bf16_mf_phase(mf, device, gpu))
        check(not late, "failed phases: " + "; ".join(late))
    except SmokeFailure as e:
        print(f"[done] {time.perf_counter() - t_start:.1f} s, failed")
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


# ---------------------------------------------------------------------------
# python3 chip_smoke.py coo-bench ROOT [ROOT ...]: the COO passes, pos_dot
# and the X^T stage of two trees on one card
# ---------------------------------------------------------------------------


def _coo_bench_calls(ops, phi, B, coo, c, w, own, oth, w_scale: float):
    """(label, call) of each COO pass of a tree, on one side's inputs: this
    tree's kernels, or a parent's (no ``pos_hv_coo``: the Hv's two-call
    form, the pair with its weights in stream order, the plain torch
    ``pos_dot``); where the tree's width-1 sums take a plan, both plans."""
    extra = []
    if hasattr(ops, "pos_hv_coo"):
        hv = ("hv pos_hv_coo", lambda: ops.pos_hv_coo(phi, B, coo, w_scale))
        pair = lambda: ops.pos_scatter_pair(c, B, coo, w_scale)  # noqa: E731
        from one_class_ffm_torch.ops import kernels
        if "lanes" in inspect.signature(kernels.pos_seg_sum).parameters:
            extra = [(f"pos_seg_sum lanes {n}",
                      lambda n=n: kernels.pos_seg_sum(c, coo, lanes=n))
                     for n in (1, 8)]
    else:
        wq = ops.storage_scale(w, w_scale)
        hv = ("hv pos_dot+pos_scatter", lambda: ops.pos_scatter(
            ops.storage_scale(ops.pos_dot(phi, own, B, oth) * w, w_scale), B,
            coo))
        pair = lambda: ops.pos_scatter_pair(c, wq, B, coo)  # noqa: E731
    return [("pos_scatter", lambda: ops.pos_scatter(c, B, coo)), hv,
            ("pos_scatter_pair", pair),
            ("pos_seg_sum", lambda: ops.pos_seg_sum(c, coo))] + extra + [
            ("pos_dot gaps", lambda: ops.pos_dot(phi, own, B, oth))]


def _torch_order(solver):
    """Put back, in this process's solver module, the COO Hv's two calls and
    ``pos_dot`` as plain torch with torch's own sum over k (the form before
    ``pos_dot`` became a kernel in ``_lane_dot``'s order), on this tree's
    other kernels: the same arithmetic as that tree, but for this tree's
    changes that claim the same bits."""
    import torch

    from one_class_ffm_torch.ops import sparse_ops as ops
    from one_class_ffm_torch.solver import torch_solver

    def pos_dot(A, u_ids, B, v_ids, max_chunk=1 << 21):
        u = u_ids.long().clamp(max=A.shape[0] - 1)
        v = v_ids.long().clamp(max=B.shape[0] - 1)
        parts = [(A[uc] * B[vc]).sum(dim=1)
                 for uc, vc in zip(u.split(max_chunk), v.split(max_chunk))]
        return torch.cat(parts) if parts else A.new_zeros(0)

    def pos_hv_coo(phi, B, coo, w_scale):
        first = coo is solver._coo(True)
        own, oth = solver._stream_ids(first)
        w = solver.data["blk_u_w" if first else "blk_v_w"]
        return ops.pos_scatter(ops.storage_scale(
            pos_dot(phi, own, B, oth) * w, w_scale), B, coo)

    torch_solver.pos_dot, torch_solver.pos_hv_coo = pos_dot, pos_hv_coo


def _trace_stop_tests(tr):
    """Replace the trainer's CG loop with ``mesh_accuracy``'s traced copy
    (the same operations in the same order, plain CG); returns the list
    that gets one list of (r2, cg_eps * g2) stop tests per solve."""
    from mesh_accuracy import _traced_cg_loop

    solves = []

    def loop(self, hv, G, D=None):
        solves.append([])
        return _traced_cg_loop(solves[-1])(self, hv, G, D)
    tr.solver._cg_loop = types.MethodType(loop, tr.solver)
    return solves


def _trace_coo_path(tr, label: str, torch_order: bool, gpu: str) -> None:
    """Train the both-COO path 3 epochs with its CG stop tests traced (with
    ``torch_order``, on ``_torch_order``'s calls); print each solve's
    r2 / (cg_eps g2) at every test, the counts and the objectives."""
    if torch_order:
        _torch_order(tr.solver)
    solves = _trace_stop_tests(tr)
    res = train_and_validate(tr, epochs=3)
    per_epoch = len(res["iters"][0])
    for h, tests in enumerate(solves):
        ratios = " ".join(f"{r2 / thr:.9g}" if thr > 0 else "inf"
                          for r2, thr in tests)
        print(f"[coo trace] {label} epoch {h // per_epoch + 1} solve "
              f"{h % per_epoch + 1} CG {len(tests) - 1}: r2/(eps g2) "
              f"{ratios}", flush=True)
    for i, its in enumerate(res["iters"]):
        print(f"[coo trace] {label} epoch {i + 1}: CG iterations per solve "
              f"{its}, objective {res['objectives'][i + 1]!r} [{gpu}]",
              flush=True)


def coo_bench_one(root: str, cache: str) -> None:
    """Time one tree's COO passes (on the FFM with both sides COO, both
    sides, and the skewed FFM's v side under Jacobi), at float32 and
    bfloat16, on arguments built from a fresh init; train each of the two
    paths 3 epochs (seconds, CG counts, objectives) and profile one more
    epoch; train the both-COO path 3 epochs more with its CG stop tests
    traced (each solve's r2 / (cg_eps g2) at every test); then time the
    refresh's ``pos_dot`` (and cuSPARSE's sampled product of the same
    function) and the X^T stage (the general scatter's source and B6/B7's
    scaled source over the headline FFM's categorical lists, and the
    general scatter over FM's wide fields, float32); each pass's time is
    printed with its device time (``device_ms``).
    ``torch-order:ROOT``: only the traced both-COO epochs, on ROOT with
    ``_torch_order``; ``passes:ROOT``: the passes' and the X^T stage's
    times alone.  The data is cached in ``cache`` by the first run."""
    import pickle

    import torch

    mode, _, path = root.rpartition(":")
    torch_order, passes = mode == "torch-order", mode == "passes"
    root = path
    sys.path.insert(0, os.path.abspath(root))
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    kernels.load()
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            ffm, skew, fm = pickle.load(fh)
    else:
        ffm = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                         **FFM_DIMS)
        skew = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                          pop_skew=1.0, **FFM_DIMS)
        fm = build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                        fm=True, **FFM_DIMS)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "wb") as fh:
            pickle.dump((ffm, skew, fm), fh, protocol=4)
    label = (f"{mode} " if mode else "") + os.path.abspath(root)
    paths = (("FFM coo", make_trainer(ffm, device, blocked_bm=0),
              (True, False)),
             ("FFM skew-coo", make_trainer(skew, device, cg_precond="jacobi",
                                           head_chunk=0), (False,)))
    for tag, tr, sides in paths if not torch_order else ():
        solver, state = tr.solver, tr.init_state()
        lay = solver.meta.layout
        b = {(x.f1, x.f2): x for x in lay.all_blocks()}[(1, lay.fu + 1)]
        for first in sides:
            s = "u" if first else "v"
            coo = solver._coo(first)
            B = state["Q" if first else "P"][b.f12]
            w = solver.data[f"blk_{s}_w"]
            c = solver._pos_coeff(state["yt_" + s]) * w
            own, oth = solver._stream_ids(first)
            gen = torch.Generator(device).manual_seed(0)
            phi = torch.randn((coo.feat_ptr.numel() - 1, B.shape[1]),
                              device=device, generator=gen)
            cp = coo.chunk_ptr.long()
            n = cp[1:] - cp[:-1]
            print(f"[coo bench] {label} {tag} {s} list: {n.numel()} chunks, "
                  f"{int(n.sum())} entries, mean {n.float().mean():.2f}, "
                  f"entry-weighted mean {float((n * n).sum() / n.sum()):.2f}"
                  f", longest {int(n.max())}", flush=True)
            for dt in (torch.float32, torch.bfloat16):
                lst = coo if coo.val is None else coo._replace(
                    val=coo.val.to(dt))
                for name, fn in _coo_bench_calls(
                        ops, phi.to(dt), B.to(dt), lst, c.to(dt), w.to(dt),
                        own, oth, 1.0 - solver.meta.hp.omega):
                    print(f"[coo bench] {label} {tag} {s} {dt} {name:24s} "
                          f"{time_ms(fn):.4f} ms (device {device_ms(fn):.4f}"
                          f" ms) [{gpu}]", flush=True)
            lib = library_call("pos_dot", (phi, own, B, oth))
            print(f"[coo bench] {label} {tag} {s} pos_dot gaps' sampled "
                  f"product (cuSPARSE SDDMM) {time_ms(lib):.4f} ms [{gpu}]",
                  flush=True)
        if passes:
            continue
        # the path itself: 3 epochs as the main path trains them, then one
        # profiled epoch
        res = train_and_validate(tr, epochs=3)
        for i, (sec, its) in enumerate(zip(res["seconds"], res["iters"])):
            print(f"[coo bench] {label} {tag} epoch {i + 1}: {sec:.4f} s, "
                  f"CG iterations per solve {its}, objective "
                  f"{res['objectives'][i + 1]:.6f} [{gpu}]", flush=True)
        profile_epoch(f"coo bench {tag}", tr, gpu)
    if not passes:  # the both-COO path's stop tests, 3 epochs from init
        _trace_coo_path(make_trainer(ffm, device, blocked_bm=0), label,
                        torch_order, gpu)
    if torch_order:
        return
    blk = make_trainer(ffm, device)
    solver, state = blk.solver, blk.init_state()
    lay = solver.meta.layout
    cross = lay.cross_blocks()[0]
    u, v = solver.data["pos_u"], solver.data["pos_v"]
    u, v = u.to(torch.int32), v.to(torch.int32)
    P, Q = state["P"][cross.f12], state["Q"][cross.f12]
    fn = lambda: ops.pos_dot(P, u, Q, v)  # noqa: E731
    lms = time_ms(library_call("pos_dot", (P, u, Q, v)))
    print(f"[coo bench] {label} FFM refresh pos_dot {time_ms(fn):.4f} ms "
          f"(device {device_ms(fn):.4f} ms), sampled product (cuSPARSE "
          f"SDDMM) {lms:.4f} ms [{gpu}]", flush=True)
    lib = kernels.load()
    b = {(x.f1, x.f2): x for x in lay.all_blocks()}[(1, lay.fu + 1)]
    for first in (True, False):
        xt = solver._x(b, first)[2]
        rows = xt.n_rows
        gen = torch.Generator(device).manual_seed(1)
        pay = torch.randn((rows, 32), device=device, generator=gen)
        scale = torch.randn((rows,), device=device, generator=gen)
        for name, fn in (
                ("X^T payload", lambda: kernels._xt_scatter(lib, pay, xt,
                                                            "scatter")),
                ("X^T scaled", lambda: kernels._xt_scatter(
                    lib, pay, xt, "scatter", scale=scale))):
            print(f"[coo bench] {label} FFM {'u' if first else 'v'} field "
                  f"{name:12s} {time_ms(fn):.4f} ms (device "
                  f"{device_ms(fn):.4f} ms) [{gpu}]", flush=True)
    # the general scatter over FM's wide fields (201,000 / 20,500 features)
    fm_solver = make_trainer(fm, device).solver
    b = fm_solver.meta.layout.cross_blocks()[0]
    for first in (True, False):
        xt = fm_solver._x(b, first)[2]
        gen = torch.Generator(device).manual_seed(2)
        pay = torch.randn((xt.n_rows, 32), device=device, generator=gen)
        fn = lambda: kernels._xt_scatter(lib, pay, xt, "scatter")  # noqa
        print(f"[coo bench] {label} FM {'u' if first else 'v'} general "
              f"scatter {time_ms(fn):.4f} ms (device {device_ms(fn):.4f} "
              f"ms) [{gpu}]", flush=True)


def coo_bench(roots) -> int:
    """Each tree in its own process, in the order given (e.g. parent,
    this tree, this tree, parent; ``torch-order:ROOT`` for
    ``_torch_order``'s traced epochs on ROOT), on the data the first one
    builds."""
    cache = os.path.join(WORK, "coo_bench_data.pkl")
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "coo-bench-one", root, cache]).returncode
        if rc:
            return rc
    return 0


# ---------------------------------------------------------------------------
# python3 chip_smoke.py cg-bench ROOT [ROOT ...]: the main paths' epochs of
# two trees on one card (the CG loop on the card against the host loop)
# ---------------------------------------------------------------------------

CG_BENCH_PATHS = ("mf", "ffm", "ffm-skew", "ffm-coo")
# ``groups:``: every main path, the group sizes there and back again, so
# that a drift of the card over the run falls on both sides of each pair
CG_GROUP_PATHS = ("mf", "ffm", "fm", "ffm-jacobi", "fm-jacobi", "ffm-skew",
                  "ffm-coo", "ffm-skew-coo")
CG_BENCH_GROUPS = (1, 2, 4, 4, 2, 1)


def _cg_bench_trainer(tag: str, data, device):
    """The trainer of main path ``tag`` (as ``main`` builds it)."""
    mf, ffm, skew, fm = data
    if tag == "mf":
        return make_trainer(mf, device)
    if tag == "ffm-skew":
        return make_trainer(skew, device)
    if tag == "ffm-skew-coo":
        return make_trainer(skew, device, cg_precond="jacobi", head_chunk=0)
    jac = "jacobi" if tag.endswith("jacobi") else "auto"
    if tag.startswith("fm"):
        return make_trainer(fm, device, cg_precond=jac)
    return make_trainer(ffm, device, cg_precond=jac,
                        blocked_bm=0 if tag == "ffm-coo" else 256)


def _stop_reads(solver, its, before) -> int:
    """Host reads of the CG stop test in an epoch: the solver's count where
    it keeps one, else the host loop's, one per test (a test before every
    iteration and the last, none where the count reached the cap)."""
    if hasattr(solver, "cg_counts"):
        return solver.cg_counts["reads"] - before
    cap = solver.meta.hp.cg_max_iter
    return int(sum(it + (it < cap) for it in its.tolist()))


def _cg_bench_profile(label: str, trainer, gpu: str) -> None:
    """One epoch under torch.profiler: busy time (the union of the device
    events' intervals), idle share, the device time of the eager
    elementwise ops the recurrence kernel replaced (aten::mul, aten::add,
    aten::sum), and the recurrence's own kernels' device time and
    launches (``CG_KERNELS``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.solver.epoch_stats(trainer.state)
        torch.cuda.synchronize()
    busy, window = _busy_window(prof)
    check(busy is not None, f"{label}: no device events in the trace")
    ops = {a.key: (a.self_device_time_total / 1e3, a.count)
           for a in prof.key_averages()
           if a.key in ("aten::mul", "aten::add", "aten::sum")}
    cg = {}
    for a in prof.key_averages():
        for k in CG_KERNELS["cg_init"] + CG_KERNELS["cg_step"]:
            if k in a.key:
                ms, c = cg.get(k, (0.0, 0))
                cg[k] = (ms + a.self_device_time_total / 1e3, c + a.count)
    print(f"[cg bench] {label} profiled epoch: device busy "
          f"{busy / 1e3:.3f} ms of {window / 1e3:.3f} ms, idle share "
          f"{1.0 - busy / window:.4f}; "
          + ", ".join(f"{k} {ms:.3f} ms in {c} calls"
                      for k, (ms, c) in sorted(ops.items()))
          + "; " + ", ".join(f"{k} {ms:.3f} ms in {c} launches"
                             for k, (ms, c) in sorted(cg.items()))
          + f" [{gpu}]", flush=True)


def cg_bench_one(root: str, cache: str) -> None:
    """One tree's main paths (MF --ns, the FFM headline, the skewed FFM,
    the FFM with both sides COO; ``CG_BENCH_PATHS``) at full width from
    the seed's tables: 3 epochs through the Trainer (seconds, CG counts),
    the peak device memory of those epochs (allocated and reserved), one
    more epoch's host reads of the stop test, then one profiled epoch.
    ``groups:ROOT``: this tree's main paths (``CG_GROUP_PATHS``) at each
    CG group size of ``CG_BENCH_GROUPS`` in turn instead (3 epochs each
    after one that captures the graphs: seconds, reads, masked
    iterations).  The data is cached in
    ``cache`` by the first run."""
    import gc
    import pickle

    import torch

    mode, _, root = root.rpartition(":")
    sys.path.insert(0, os.path.abspath(root))
    from one_class_ffm_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    kernels.load()
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            data = pickle.load(fh)
    else:
        data = (build_data(N_USERS, N_ITEMS, 5.0, seed=0),
                build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                           **FFM_DIMS),
                build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                           pop_skew=1.0, **FFM_DIMS),
                build_data(N_USERS, N_ITEMS, 5.0, seed=0, self_side=True,
                           fm=True, **FFM_DIMS))
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "wb") as fh:
            pickle.dump(data, fh, protocol=4)
    label = (f"{mode} " if mode else "") + os.path.abspath(root)
    for tag in CG_GROUP_PATHS if mode == "groups" else CG_BENCH_PATHS:
        gc.collect()
        torch.cuda.empty_cache()
        tr = _cg_bench_trainer(tag, data, device)
        solver = tr.solver
        if mode == "groups":
            state0 = tr.init_state()
            for g in CG_BENCH_GROUPS:
                solver.cg_group = g
                state, _ = solver.epoch_stats(state0)  # captures
                c0 = dict(solver.cg_counts)
                secs, its = [], []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, it = solver.epoch_stats(state)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    its.append(int(it.sum()))
                c1 = solver.cg_counts
                print(f"[cg bench] {label} {tag} group {g}: epochs "
                      f"{', '.join(f'{x:.4f}' for x in secs)} s, "
                      f"iterations {its}, host reads "
                      f"{c1['reads'] - c0['reads']}, masked iterations "
                      f"{c1['masked'] - c0['masked']} (3 epochs) [{gpu}]",
                      flush=True)
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = train_and_validate(tr, epochs=3)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        for i, (sec, its) in enumerate(zip(res["seconds"], res["iters"])):
            print(f"[cg bench] {label} {tag} epoch {i + 1}: {sec:.4f} s, CG "
                  f"iterations per solve {its} [{gpu}]", flush=True)
        print(f"[cg bench] {label} {tag} peak device memory of the 3 epochs "
              f"and validation: allocated {peak} B, reserved {reserved} B "
              f"[{gpu}]", flush=True)
        before = getattr(solver, "cg_counts", {}).get("reads", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, its = solver.epoch_stats(tr.state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"[cg bench] {label} {tag} epoch 4: {sec:.4f} s, "
              f"{int(its.sum())} CG iterations in {its.numel()} solves, "
              f"{_stop_reads(solver, its, before)} host reads of the stop "
              f"test [{gpu}]", flush=True)
        _cg_bench_profile(f"{label} {tag}", tr, gpu)
        del tr, solver


# python3 chip_smoke.py cg-kernels ROOT [ROOT ...]: the recurrence kernels
# of several trees on one card, each tree in its own process
CG_KERNEL_SHAPES = ((N_USERS, 32), (N_ITEMS, 32))  # MF's u and v tables


def cg_kernels_one(root: str) -> None:
    """cg_init and cg_step of the tree at ROOT at the MF solves' shapes,
    f32 and bf16 storage, plain CG and Jacobi, on G, D and an Hv made from
    a seed (Hv = 2 V + 0.1 noise after the start): bit-equality with the
    plain versions after the start and one step, then ``_cg_times``' times,
    bound, launches and launch (f32; bf16 beside it)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from one_class_ffm_torch.ops import kernels
    from one_class_ffm_torch.ops import sparse_ops as ops

    device = torch.device("cuda", 0)
    gpu = gpu_line()
    kernels.load()
    label = os.path.abspath(root)
    rng = np.random.default_rng(0)
    for rows, k in CG_KERNEL_SHAPES:
        def T(a):
            return torch.from_numpy(a.astype(np.float32)).to(device)

        G32 = T(rng.normal(size=(rows, k)))
        D32 = T(rng.uniform(0.5, 2.0, size=(rows, k)))
        noise = T(rng.normal(size=(rows, k)))
        for jacobi in (False, True):
            for dt_name, dt in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16)):
                G, D = G32.to(dt), D32 if jacobi else None
                st_p = ops.cg_init_plain(G, D, dt, 1e-6, 20)
                Hv = (2.0 * st_p.V + 0.1 * noise).to(dt)
                st_k = kernels.cg_init(G, D, dt, 1e-6, 20)
                eq_init, _ = _cg_agree(st_k, st_p)
                kernels.cg_step(st_k, Hv)
                ops.cg_step_plain(st_p, Hv)
                eq_step, _ = _cg_agree(st_k, st_p)
                for name, eq in (("cg_init", eq_init), ("cg_step", eq_step)):
                    r = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
                    print(f"[cg kernels] {label} {name} {rows}x{k} "
                          f"{dt_name} jacobi {jacobi}: bit-equal {eq};"
                          + _cg_times(name, G, D, Hv, dt, 1e-6, 20, r, gpu),
                          flush=True)
                    check(eq, f"{label} {name}: not its plain version's bits")


def topk_segments(device, gpu: str) -> None:
    """``topk_rows`` at 1 to 1,024 rows of the catalog's 359,966 columns,
    K = 10 and 80, float32 and bfloat16: the launch at the segments a row
    that ``kernels.topk_segs`` chooses against one segment a row and a few
    other counts (``time_ms``), the ids the same at every count."""
    import torch

    from one_class_ffm_torch.ops import kernels

    lib = kernels.load()
    n = TOPK_SHAPE[1]
    g = torch.Generator(device=device).manual_seed(1)
    z32 = torch.randn((1024, n), generator=g, device=device)
    tickets = torch.zeros(1024, dtype=torch.int32, device=device)
    for dt in (torch.float32, torch.bfloat16):
        zz = z32 if dt == torch.float32 else z32.bfloat16()
        for rows in (1, 16, 64, 256, 1024):
            for k in TOPK_KS:
                z = zz[:rows]
                chosen = kernels.topk_segs(rows, n, k, dt)
                vals = torch.empty((rows, k), dtype=dt, device=device)
                ids = torch.empty((rows, k), dtype=torch.int64,
                                  device=device)
                first, times = None, {}
                for segs in sorted({1, 2, 4, 16, chosen}):
                    part = torch.empty(rows * segs * k, dtype=torch.int64,
                                       device=device)

                    def launch(segs=segs, part=part):
                        check(lib.ocffm_topk_rows(
                            kernels._DTYPE_CODE[dt], z.data_ptr(),
                            z.stride(0), rows, n, k, segs, vals.data_ptr(),
                            ids.data_ptr(), part.data_ptr(),
                            tickets.data_ptr(),
                            kernels._stream(device)) == 0,
                            f"topk_rows {segs} segments: launch failed")

                    times[segs] = time_ms(launch)
                    first = ids.clone() if first is None else first
                    check(torch.equal(ids, first),
                          f"topk_rows {rows} rows {segs} segments: ids "
                          f"differ")
                print(f"[kernels] topk_rows segments {rows}x{n} k={k} "
                      f"{str(dt)[6:]}: chosen {chosen}; "
                      + ", ".join(f"{s_} {ms:.4f} ms"
                                  for s_, ms in times.items())
                      + f"; one a row over chosen "
                      f"{times[1] / times[chosen]:.2f} [{gpu}]")


def topk_kernels() -> int:
    """``topk_phase`` and ``topk_segments`` alone, then the entry's JSON
    line."""
    import torch

    from one_class_ffm_torch.ops import kernels

    device = torch.device("cuda", 0)
    gpu = gpu_line()
    kernels.load()
    print(f"[build] {kernels.library_path().name} in "
          f"{kernels.build_seconds:.2f} s")
    report = new_report()
    try:
        topk_phase(device, gpu, report)
        topk_segments(device, gpu)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    r = report["topk_rows"]
    bms, by = bound_of(r["nbytes"], r["ops"])
    print(json.dumps(dict(name="topk_rows", source=SOURCE["topk_rows"],
                          replaces=REPLACES["topk_rows"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=bms, bound_by=by,
                          library_ms=r["library_ms"])))
    return 0


def cg_kernels(roots) -> int:
    """Each tree in its own process, in the order given (e.g. parent, this
    tree, this tree, parent)."""
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "cg-kernels-one", root]).returncode
        if rc:
            return rc
    return 0


def cg_bench(roots) -> int:
    """Each tree in its own process, in the order given (e.g. parent, this
    tree, this tree, parent; ``groups:ROOT`` for the CG group sizes on
    ROOT), on the data the first one builds."""
    cache = os.path.join(WORK, "cg_bench_data.pkl")
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "cg-bench-one", root, cache]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["coo-bench"]:
        sys.exit(coo_bench(sys.argv[2:]))
    if sys.argv[1:2] == ["coo-bench-one"]:
        coo_bench_one(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["cg-bench"]:
        sys.exit(cg_bench(sys.argv[2:]))
    if sys.argv[1:2] == ["cg-bench-one"]:
        cg_bench_one(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["cg-kernels"]:
        sys.exit(cg_kernels(sys.argv[2:]))
    if sys.argv[1:2] == ["cg-kernels-one"]:
        cg_kernels_one(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["topk-kernels"]:
        sys.exit(topk_kernels())
    sys.exit(main())
