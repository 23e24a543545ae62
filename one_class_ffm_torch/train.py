"""End-to-end trainer of the PyTorch port.

Counterpart of ``one_class_ffm_tpu/train.py``, on one device, on a data
mesh or on a 2-D ``data x model`` mesh of ``torch.distributed`` ranks
(``mesh_shape``, one process per rank: ``torchrun ... --mesh N
--distributed`` or ``--mesh NxM``, tables of at least ``model_min_rows``
rows row-sharded on the model axis).  The host-side
pieces are copies of the JAX package's, unchanged, so that the port imports
nothing of it (``tests/test_torch_copies.py`` holds each copy equal to its
original): the run configuration (``TrainConfig``), the data pipeline
(``load_problem``), the text model and npz checkpoint formats, and the
header / log-row / JSONL formatting, so the port's output is
byte-compatible with the reference's log tools.  ``--ckpt-format orbax``
writes the sharded-native checkpoints of ``utils.sharded_ckpt``
(``torch.distributed.checkpoint``; not orbax's files).

``dtype="auto"`` means float32 here on every device: bfloat16 MF stops
learning above a size, as the JAX package's own bfloat16 does (ROADMAP
C3), and its throughput on the GPU is not measured yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.dataset import (
    Interactions,
    PaddedFields,
    PaddedLabels,
    pad_fields,
    pad_labels,
    read_data,
    split_fields,
)
from .evalx.torch_eval import Evaluator, make_eval_data
from .models.blocks import BlockLayout
from .parallel.distributed import init_distributed
from .parallel.mesh import resolve_mesh, shard_data, shard_state
from .solver.convert import pad_table, params_from_numpy, params_to_numpy
from .solver.params import HyperParams
from .solver.torch_solver import FFMSolver, make_device_data
from .utils import sharded_ckpt
from .utils.device import resolve_device
from .utils.profiling import PhaseTimer, trace_profile

TOP_KS = (5, 10, 20, 40, 80)


class NonFiniteMetricError(RuntimeError):
    """Raised by the finiteness tripwire when an eval metric goes NaN/inf
    (poisoned model state); see Trainer._check_finite."""


@dataclass
class TrainConfig:
    """Run configuration (reference Option, train.cpp:7-19 + new fields)."""

    item_path: str
    train_path: str
    test_path: Optional[str] = None
    model_path: Optional[str] = None  # reference text-format export (-o)
    ckpt_dir: Optional[str] = None  # native checkpoint directory
    k: int = 4
    lam: float = 0.1  # train.cpp help default
    omega: float = 0.1
    r: float = -1.0
    nr_pass: int = 20
    self_side: bool = True  # --ns sets False
    freq: bool = False
    seed: int = 0
    # "auto": float32 in the port (resolve_dtype); the JAX package's "auto"
    # is bfloat16 on a TPU
    dtype: str = "auto"
    eval_every: int = 10  # reference hard-codes 10 (ffm.cpp:1155)
    eval_chunk: int = 1024
    row_multiple: int = 8  # pad rows for TPU tiling / even sharding
    jsonl_path: Optional[str] = None
    resume: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace output
    timing: bool = False  # print per-phase timing at the end
    ckpt_format: str = "npz"  # "npz" (single-host) | "orbax" (sharded-native)
    init_model: Optional[str] = None  # warm-start from a text model file
    # --- mesh / distributed execution (reference analog: train.cpp:174
    # omp_set_num_threads — the parallelism knob wired into the binary) ---
    mesh_shape: Optional[str] = None  # None | "auto" | "N" | "NxM" (dataxmodel)
    model_min_rows: int = 4096  # row-shard tables >= this on the model axis
    distributed: bool = False  # join torchrun's process group before meshing
    # eval sharding axis: "users" (row-DP), "items" (catalog-sharded top-K
    # merge — scales past the dense (chunk, n) cliff), or "auto" (items when
    # the catalog exceeds eval_item_threshold)
    eval_shard: str = "auto"
    eval_item_threshold: int = 1 << 18
    # CG flavor: "auto" (plain CG, the reference-exact solver;
    # jax_solver.py:517-519), "jacobi" (diagonal-preconditioned opt-in, same
    # stop rule), or "none" (plain CG)
    cg_precond: str = "auto"
    # rows per block for the blocked-sorted positive ops (u-side segment
    # sums as one-hot MXU matmuls).  0 disables.  Auto-disabled when the
    # stream's row skew would over-pad (ops.make_blocked_layout).  Under a
    # data mesh the u-side runs SHARD-ALIGNED (pad_labels shard_rows= +
    # shard_map-local blocked ops — no per-iteration collectives); the
    # v side keeps the plain COO ops there.
    blocked_bm: int = 256
    # internal: set by Trainer under a data mesh — the stream is laid out
    # shard-aligned over this many shards (0 = flat layout)
    stream_shards: int = 0
    # finiteness tripwire: fail LOUDLY when an eval metric goes NaN/inf
    # instead of logging `ploss: nan` to completion (the round-4 f32 CG
    # underflow trained 90 nan epochs undetected; the reference would have
    # logged nan silently too — ffm.cpp:1002 has no guard)
    nan_guard: bool = True
    # divergence tripwire: ploss (positive-pair RMSE, O(1) for any sane
    # model of +-1-ish targets; the whole 664-log reference corpus tops out
    # at 5.4) above this aborts like the nan guard — a finite explosion
    # (the round-5 bf16 spiral printed ploss 77 at its first bad eval,
    # then 1e9+) must not train on.  0 disables.
    max_ploss: float = 50.0
    # Re-derive the incremental caches (P/Q, a/b, the residual carry yt)
    # from the block tables every N epochs.  The solver, like the
    # reference (init_y_tilde/update_* ffm.cpp:388-465), updates these
    # INCREMENTALLY after every half-solve; at f64 that is harmless, but
    # at bf16 storage the bookkeeping error COMPOUNDS — measured on the
    # k=16 sweep tier: carried-vs-recomputed residual drift reaches ~1%
    # mean by epoch 25, then feeds back through the Gauss-Newton steps and
    # the whole model explodes to |W| ~ 1e3 within 5 more epochs
    # (docs/PARITY.md incident log, round 5).  A periodic re-derivation
    # resets the drift; one refresh is ~one gradient-pass of work, so at
    # the default cadence the overhead is ~1-2%.  None = auto: every 10
    # epochs at bf16 storage, off at f32/f64 (f32 holds parity to 100
    # epochs unrefreshed — PARITY.md sweep tier).  0 disables.
    refresh_every: Optional[int] = None

    def hyper(self) -> HyperParams:
        return HyperParams(
            k=self.k,
            lam=self.lam,
            omega=self.omega,
            r=self.r,
            nr_pass=self.nr_pass,
            self_side=self.self_side,
            freq=self.freq,
            cg_precond=self.cg_precond,
        )


@dataclass
class LoadedData:
    """Everything host-side the trainer needs."""

    layout: BlockLayout
    u_pad: PaddedFields
    v_pad: PaddedFields
    y_pad: PaddedLabels
    popular: np.ndarray
    uva_pad: Optional[PaddedFields]
    va_labels: Optional[List[np.ndarray]]
    n_items_true: int
    m_users_true: int
    nnz_true: int


def load_problem(cfg: TrainConfig) -> LoadedData:
    """Replicates main()'s data pipeline (train.cpp:177-192):
    read train (labels) -> split; read items -> split; test with the train
    Ds filter.  Training positives with item id >= item-file rows are dropped
    (the reference drops them in transY, ffm.cpp:267-268)."""
    u_raw = read_data(cfg.train_path, has_label=True)
    u_fd = split_fields(u_raw)
    v_raw = read_data(cfg.item_path, has_label=False)
    v_fd = split_fields(v_raw)

    layout = BlockLayout.make(u_fd.Ds, v_fd.Ds, cfg.self_side)

    dt = np.float64 if cfg.dtype == "float64" else np.float32
    mult = max(1, cfg.row_multiple)
    u_pad = pad_fields(u_fd, row_multiple=mult, dtype=dt)
    v_pad = pad_fields(v_fd, row_multiple=mult, dtype=dt)

    # training positives: COO with v < item rows
    assert u_raw.y is not None
    uu = u_raw.y.row_ids()
    vv = u_raw.y.col
    keep = vv < v_fd.m
    y = Interactions(
        m=u_fd.m,
        n=v_fd.m,
        indptr=_rebuild_indptr(uu[keep], u_fd.m),
        col=vv[keep],
    )
    y_pad = pad_labels(
        y, u_pad.m, v_pad.m, nnz_multiple=mult * 8, dtype=dt,
        shard_rows=(u_pad.m // cfg.stream_shards
                    if cfg.stream_shards > 1 else 0),
    )

    uva_pad = None
    va_labels = None
    if cfg.test_path:
        t_raw = read_data(cfg.test_path, has_label=True, ds=u_fd.Ds)
        t_fd = split_fields(t_raw, f_override=u_fd.f)
        uva_pad = pad_fields(t_fd, row_multiple=mult, dtype=dt)
        assert t_raw.y is not None
        va_labels = [
            t_raw.y.col[t_raw.y.indptr[i] : t_raw.y.indptr[i + 1]]
            for i in range(t_raw.m)
        ]

    assert u_raw.popular is not None
    return LoadedData(
        layout=layout,
        u_pad=u_pad,
        v_pad=v_pad,
        y_pad=y_pad,
        popular=u_raw.popular,
        uva_pad=uva_pad,
        va_labels=va_labels,
        n_items_true=v_fd.m,
        m_users_true=u_fd.m,
        nnz_true=y_pad.nnz_true,
    )


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def _rebuild_indptr(rows: np.ndarray, m: int) -> np.ndarray:
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr)


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    """Storage dtype by name; "auto" is float32 (ROADMAP C3: bfloat16
    MF stops learning above a size, in the JAX package too)."""
    return torch.float32 if name == "auto" else _DTYPES[name]


class Trainer:
    """Owns the solver + evaluator for one run, on one device or on a mesh
    (``cfg.mesh_shape``; ``cfg.distributed`` joins torchrun's process group
    first: NCCL with a card per rank, gloo for a CPU run; a group that
    already exists is used as it is).  Under a mesh each rank builds the
    full host arrays the same way from the seed and keeps its part
    (``parallel.shard_data``, on the shard-aligned stream whatever
    ``blocked_bm``); the tables are replicated, or on an ``NxM`` mesh those
    of at least ``cfg.model_min_rows`` rows row-sharded on the model axis
    (table dims padded to a multiple of M, ``d_multiple``; the files keep
    true dims), and rank 0 alone writes the model, checkpoint and JSONL
    files.
    ``head_chunk``: the chunk width of a popularity-skewed side's head tier
    (``make_device_data``)."""

    def __init__(self, cfg: TrainConfig, data: Optional[LoadedData] = None,
                 device: torch.device | str = "cuda", head_chunk: int = 512):
        if (cfg.resume and cfg.ckpt_format == "orbax" and cfg.ckpt_dir
                and sharded_ckpt.has_jax_checkpoint(cfg.ckpt_dir)):
            raise ValueError(
                f"--resume: {cfg.ckpt_dir} holds an orbax checkpoint of the "
                f"JAX package ({sharded_ckpt.JAX_META}); the port's "
                "--ckpt-format orbax is written by torch.distributed."
                "checkpoint and cannot read orbax's files (resume it with "
                "the JAX package, or pass its text model as --init-model)")
        self.device = resolve_device(device)
        # mesh resolution BEFORE the data layout: the padding multiples
        # must divide the data axis (train.py:250-296 of the JAX package)
        if cfg.distributed:
            init_distributed(
                backend="gloo" if self.device.type == "cpu" else "nccl")
        self.mesh = resolve_mesh(cfg.mesh_shape, device=self.device)
        n_data = n_model = 1
        if self.mesh is not None:
            self.device = self.mesh.device
            n_data, n_model = self.mesh.size, self.mesh.n_model
            # rows divide n_data * blocked_bm, so that blocks nest in ranks
            cfg = dataclasses.replace(
                cfg,
                row_multiple=_lcm(max(1, cfg.row_multiple),
                                  n_data * max(1, cfg.blocked_bm)),
                eval_chunk=_lcm(max(1, cfg.eval_chunk), n_data),
                stream_shards=n_data if n_data > 1 else 0)
        elif cfg.blocked_bm > 0:
            # user and item rows must divide the block size
            cfg = dataclasses.replace(
                cfg, row_multiple=_lcm(max(1, cfg.row_multiple),
                                       cfg.blocked_bm))
        self.cfg = cfg
        sharded = n_data > 1
        # rank 0 writes the files of a run on a mesh
        self.is_writer = self.mesh is None or (self.mesh.rank == 0
                                               and self.mesh.model_rank == 0)
        self.data = data if data is not None else load_problem(cfg)
        d = self.data
        self.dtype = resolve_dtype(cfg.dtype)
        self.meta, dev = make_device_data(
            d.u_pad, d.v_pad, d.y_pad, d.layout, cfg.hyper(),
            dtype=self.dtype, blocked_bm=cfg.blocked_bm,
            head_chunk=head_chunk,
            device="cpu" if sharded else self.device,
            blocked_shards=max(1, cfg.stream_shards), d_multiple=n_model)
        if sharded:
            dev = shard_data(dev, self.mesh)
        self.model_min_rows = cfg.model_min_rows if n_model > 1 else None
        self.solver = FFMSolver(self.meta, dev, mesh=self.mesh,
                                model_min_rows=self.model_min_rows)
        self.evaluator = None
        if d.uva_pad is not None and d.va_labels:
            emeta, edata = make_eval_data(
                d.uva_pad, d.va_labels, d.popular, n_items=d.v_pad.m,
                n_items_true=d.n_items_true, layout=d.layout,
                dtype=self.dtype, top_ks=TOP_KS, device=self.device)
            self.evaluator = Evaluator(emeta, edata, chunk=cfg.eval_chunk)
            if sharded:
                by_items = cfg.eval_shard == "items" or (
                    cfg.eval_shard == "auto"
                    and emeta.n >= cfg.eval_item_threshold)
                self.evaluator = (self.evaluator.shard_items(self.mesh)
                                  if by_items
                                  else self.evaluator.shard(self.mesh))
        self.state = None
        self.epoch_idx = 0
        # bf16's incremental bookkeeping drift is reset periodically
        # (TrainConfig.refresh_every)
        if cfg.refresh_every is not None:
            self.refresh_every = int(cfg.refresh_every)
        else:
            self.refresh_every = 10 if self.dtype == torch.bfloat16 else 0
        self.timer = PhaseTimer()
        # per sharded checkpoint saved or loaded on this rank: {"op": "save"
        # | "load", "epoch", "bytes" (of the files written; 0 on a load),
        # "seconds"; a save's "mesh_seconds": making the DeviceMesh}
        self.ckpt_stats: List[Dict[str, Any]] = []
        # per trained epoch: {"epoch", "seconds", "cg_iters"} (the per-solve
        # CG iteration counts in epoch_order, f1 then f2 half of each block)
        self.history: List[Dict[str, Any]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _place_state(self, state):
        """A full state (tensors or numpy arrays, on the layout of the full
        data; tables at true or padded dims) cut to this rank's part on a
        mesh; on one device, as given."""
        if self.mesh is None:
            return state
        params = {f12: {k: pad_table(v, self.meta.pad_d)
                        for k, v in blk.items()}
                  for f12, blk in state["params"].items()}
        return shard_state(dict(state, params=params), self.mesh,
                           model_min_rows=self.model_min_rows,
                           data=self.solver.data)

    # -- lifecycle ------------------------------------------------------------

    def init_state(self):
        cfg = self.cfg
        if cfg.ckpt_format == "orbax":
            found = cfg.ckpt_dir and sharded_ckpt.has_checkpoint(cfg.ckpt_dir)
        else:
            found = cfg.ckpt_dir and has_checkpoint(cfg.ckpt_dir)
        if cfg.resume and found:
            self.load_checkpoint()
        elif cfg.init_model:
            self.warm_start(cfg.init_model)
        else:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.state = self.solver.init(gen)
            self.epoch_idx = 0
        return self.state

    def _load_params(self, params_np) -> None:
        self.state = self.solver.refresh_caches(
            {"params": params_from_numpy(params_np, self.device, self.dtype,
                                         pad_d=self.meta.pad_d)})

    def warm_start(self, model_path: str):
        """Initialize from a saved text model (ours or the reference's own
        save_model output, ffm.cpp:1163-1237)."""
        layout, k, params_np = load_text_model(model_path)
        lay = self.data.layout
        if k != self.cfg.k:
            raise ValueError(f"model k={k} != config k={self.cfg.k}")
        if (layout.fu, layout.fv) != (lay.fu, lay.fv):
            raise ValueError(f"model fields ({layout.fu},{layout.fv}) != "
                             f"data ({lay.fu},{lay.fv})")
        params = {}
        for b in lay.all_blocks():
            W = np.zeros((b.d1, k))
            H = np.zeros((b.d2, k))
            # model dims may be smaller than this dataset's: new rows start
            # at zero
            w_src, h_src = params_np[b.f12]["W"], params_np[b.f12]["H"]
            W[: min(b.d1, w_src.shape[0])] = w_src[: b.d1]
            H[: min(b.d2, h_src.shape[0])] = h_src[: b.d2]
            params[b.f12] = {"W": W, "H": H}
        self._load_params(params)
        self.epoch_idx = 0

    def load_checkpoint(self):
        if self.cfg.ckpt_format == "orbax":
            self._load_sharded()
            return
        params_np, epoch = load_checkpoint(self.cfg.ckpt_dir)
        self._load_params(params_np)
        self.epoch_idx = epoch

    def _ckpt_mesh(self):
        """The mesh a sharded checkpoint is saved and restored on, or None
        for one process (a mesh of one rank included)."""
        m = self.mesh
        return m if m is not None and m.size * m.n_model > 1 else None

    def _load_sharded(self):
        """A sharded checkpoint restored onto this run's topology (on a mesh
        each rank reads its own model rows of a row-sharded table), then the
        caches re-derived from the tables.  Without a mesh the whole tables
        come back at the padded dims they were saved at: cut to true dims
        here (pad rows are zero), padded again by the solver."""
        self._sync()
        t0 = time.perf_counter()
        if self._ckpt_mesh() is not None:
            params, epoch = sharded_ckpt.load(
                self.cfg.ckpt_dir, mesh=self.mesh,
                specs=self.solver.table_specs(), dtype=self.dtype)
        else:
            tables, epoch = sharded_ckpt.load(self.cfg.ckpt_dir)
            params = {b.f12: {
                name: tables[b.f12][name][:d].to(self.device, self.dtype)
                for name, d in (("W", b.d1), ("H", b.d2))}
                for b in self.data.layout.all_blocks()}
        self.state = self.solver.refresh_caches({"params": params})
        self.epoch_idx = epoch
        self._sync()
        self.ckpt_stats.append(dict(op="load", epoch=epoch, bytes=0,
                                    seconds=time.perf_counter() - t0))

    def save_checkpoint(self):
        lay = self.data.layout
        layout_doc = dict(fu=lay.fu, fv=lay.fv, Du=list(lay.Du),
                          Dv=list(lay.Dv), self_side=lay.self_side)
        if self.cfg.ckpt_format == "orbax":
            # every rank: DCP's save is collective, and each rank writes its
            # own rows of a model-sharded table (no gather)
            self._sync()
            t0 = time.perf_counter()
            mesh = self._ckpt_mesh()
            if mesh is not None:
                mesh.device_mesh()  # made at the first save
            t1 = time.perf_counter()
            nbytes = sharded_ckpt.save(
                self.cfg.ckpt_dir, self.state["params"], self.epoch_idx,
                meta=dict(k=self.cfg.k, layout=layout_doc), mesh=mesh,
                specs=self.solver.table_specs())
            self.ckpt_stats.append(dict(op="save", epoch=self.epoch_idx,
                                        bytes=nbytes, mesh_seconds=t1 - t0,
                                        seconds=time.perf_counter() - t1))
            return
        params = self.params_numpy()  # every rank: a model axis gathers
        if not self.is_writer:
            return
        save_checkpoint(self.cfg.ckpt_dir, params, self.epoch_idx, self.cfg,
                        layout=layout_doc)

    def describe(self, log=print):
        """Dataset summary (reference print_data_info, ffm.cpp:296-312)."""
        d = self.data
        cfg = self.cfg
        log(f"train: {cfg.train_path}  users={d.m_users_true} "
            f"fields={d.u_pad.f} dims={list(d.u_pad.Ds)} "
            f"positives={d.nnz_true}")
        log(f"items: {cfg.item_path}  items={d.n_items_true} "
            f"fields={d.v_pad.f} dims={list(d.v_pad.Ds)} "
            f"catalog={len(d.popular)}")
        if d.uva_pad is not None:
            n_labels = sum(len(l) for l in d.va_labels)
            log(f"test:  {cfg.test_path}  users={len(d.va_labels)} "
                f"labels={n_labels}")
        blocks = d.layout.all_blocks()
        n_params = sum(b.d1 * cfg.k + b.d2 * cfg.k for b in blocks)
        log(f"model: k={cfg.k} blocks={len(blocks)} "
            f"(self_side={cfg.self_side}) params={n_params:,}")

    # -- training loop --------------------------------------------------------

    def run(self, log=print) -> Dict[str, float]:
        """Full solve loop (reference solve(), ffm.cpp:1147-1161)."""
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        self._print_header(log)
        metrics: Dict[str, float] = {}
        with trace_profile(cfg.profile_dir, self.device):
            while self.epoch_idx < cfg.nr_pass:
                self._sync()
                t0 = time.perf_counter()
                with self.timer.phase("epoch"):
                    self.state, iters = self.solver.epoch_stats(self.state)
                    self._sync()
                self.epoch_idx += 1
                t_epoch = time.perf_counter() - t0
                self.history.append(dict(epoch=self.epoch_idx,
                                         seconds=t_epoch,
                                         cg_iters=iters.tolist()))
                if (self.refresh_every
                        and self.epoch_idx % self.refresh_every == 0):
                    with self.timer.phase("refresh"):
                        self.state = self.solver.refresh_caches(
                            {"params": self.full_params()})
                if (self.evaluator is not None
                        and self.epoch_idx % cfg.eval_every == 0):
                    with self.timer.phase("validate"):
                        metrics = self.validate()
                    self._check_finite(metrics)
                    log(self._format_row(self.epoch_idx, metrics))
                    if self.is_writer:
                        self._write_jsonl(self.epoch_idx, metrics, t_epoch)
                if cfg.ckpt_dir and self.epoch_idx % cfg.eval_every == 0:
                    with self.timer.phase("checkpoint"):
                        self.save_checkpoint()
        if cfg.model_path:
            self.save_model(cfg.model_path)
        if cfg.ckpt_dir:
            self.save_checkpoint()
        if cfg.timing:
            self.timer.report(log)
        return metrics

    def save_model(self, path: str) -> None:
        """The text model at true dims, written by rank 0 of a mesh (every
        rank gathers the model-sharded tables first)."""
        params = self.params_numpy()
        if self.is_writer:
            save_text_model(path, params, self.data.layout, self.cfg.k)

    def validate(self) -> Dict[str, float]:
        if self.evaluator is None:
            raise RuntimeError("no test set: construct with cfg.test_path")
        st = self.state
        return self.evaluator.validate(self.full_params(), st["Q"], st["b"])

    def full_params(self):
        """The whole tables (model-sharded ones gathered over the model
        group), at padded dims."""
        return self.solver.full_params(self.state["params"], "read")

    def _check_finite(self, metrics: Dict[str, float]):
        """Finiteness and divergence tripwire (the reference trainer's
        _check_finite): fail at the first bad eval, naming the blocks."""
        if not self.cfg.nan_guard:
            return
        bad = sorted(k for k, v in metrics.items()
                     if not math.isfinite(float(v)))
        if (not bad and self.cfg.max_ploss
                and float(metrics.get("ploss", 0.0)) > self.cfg.max_ploss):
            bad = [f"ploss={float(metrics['ploss']):.3g} > "
                   f"max_ploss={self.cfg.max_ploss:g} (diverged)"]
        if not bad:
            return
        culprits = []
        for f12, blk in sorted(params_to_numpy(self.state["params"]).items()):
            for name in ("W", "H"):
                n_bad = int(blk[name].size - np.isfinite(blk[name]).sum())
                if n_bad:
                    culprits.append(f"{name}[f12={f12}] ({n_bad} entries)")
        raise NonFiniteMetricError(
            f"non-finite eval metrics at epoch {self.epoch_idx}: "
            f"{', '.join(bad)}; non-finite table blocks: "
            f"{', '.join(culprits) if culprits else 'none (eval-side)'}. "
            "Training aborted — the model state is poisoned and every "
            "further epoch would train on it (disable with --no-nan-guard "
            "for forensics).")

    # -- output formatting (log-tooling compatible) ---------------------------

    def _print_header(self, log):
        if self.evaluator is None:
            return
        cols = ["iter"]
        for k in TOP_KS:
            cols.append(f"( p@ {k}, nDCG@{k} )")
        cols.append("ploss")
        log(" ".join(cols))

    def _format_row(self, t: int, m: Dict[str, float]) -> str:
        """One validation row, reference format: metrics x100, %.3g
        (print_epoch_info, ffm.cpp:1130-1145)."""
        parts = [f"{t:>2}"]
        for k in TOP_KS:
            parts.append(f"( {m[f'p@{k}'] * 100:.3g} , {m[f'ndcg@{k}'] * 100:.3g} )")
        parts.append(f"{m['ploss']:.3g}")
        return " ".join(parts)

    def _write_jsonl(self, t: int, m: Dict[str, float], t_epoch: float):
        if not self.cfg.jsonl_path:
            return
        rec = dict(
            epoch=t,
            epoch_seconds=t_epoch,
            examples_per_sec=self.data.m_users_true / max(t_epoch, 1e-9),
            **m,
        )
        with open(self.cfg.jsonl_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    # -- io -------------------------------------------------------------------

    def params_numpy(self):
        """Host copies of the block tables at their true field dims."""
        dims = {b.f12: dict(W=b.d1, H=b.d2)
                for b in self.data.layout.all_blocks()}
        return params_to_numpy(self.full_params(), dims)

    def predict_topk(self, k: int = 10, chunk: int = 1024) -> np.ndarray:
        """Top-k item ids for every test user (cold users ranked by
        popularity; ties to the lowest id), using the current parameters.
        Under an item-sharded evaluator the catalog stays sharded: each
        rank's candidates merge (``make_sharded_topk_fn``, the JAX
        package's train.py:623-640); under a user-sharded one each rank
        ranks its users and the ids are gathered.  Every rank returns all
        users' ids."""
        if self.evaluator is None:
            raise RuntimeError("no test set: construct with cfg.test_path")
        ev = self.evaluator
        Pva, _ = ev._project_users(self.full_params())
        meta = ev.meta
        Q, bt = self.state["Q"], self.state["b"]
        if ev.shard_by == "items":
            from .evalx.sharded_topk import make_sharded_topk_fn

            fn = make_sharded_topk_fn(
                [b.f12 for b in meta.layout.cross_blocks()], ev.mesh, k,
                catalog=meta.catalog)
            outs = []
            for lo in range(0, meta.mt_true, chunk):
                sl = slice(lo, min(lo + chunk, meta.mt_true))
                _, ids = fn({f12: P[sl] for f12, P in Pva.items()},
                            ev.data["cold"][sl], Q, bt, ev.data["popular"])
                outs.append(ids.cpu().numpy())
            return np.concatenate(outs, axis=0)
        rows = meta.mt_true
        if ev.shard_by == "users":
            rows = ev.data["labels"].shape[0]  # this rank's padded rows
            Q = {b.f12: ev.mesh.all_gather(Q[b.f12], "predict")
                 for b in meta.layout.cross_blocks()}
            bt = ev.mesh.all_gather(bt, "predict")
        outs = []
        for lo in range(0, rows, chunk):
            sl = slice(lo, min(lo + chunk, rows))
            z = ev.scores({f12: P[sl] for f12, P in Pva.items()},
                          ev.data["cold"][sl], Q, bt)[:, : meta.catalog]
            top = torch.sort(z, dim=1, descending=True, stable=True).indices
            outs.append(top[:, :k])
        ids = torch.cat(outs, dim=0)
        if ev.shard_by == "users":
            ids = ev.mesh.all_gather(ids, "predict")[: meta.mt_true]
        return ids.cpu().numpy()


# ---------------------------------------------------------------------------
# Model persistence
# ---------------------------------------------------------------------------


def save_text_model(
    path: str,
    params: Dict[int, Dict[str, np.ndarray]],
    layout: BlockLayout,
    k: int,
):
    """Reference text model format (save_model, ffm.cpp:1163-1237):
    header f/fu/fv/k + per-field dims, then per block rows
    ``W,fi,fj,row v1 .. vk`` in %g formatting."""
    f = layout.f
    with open(path, "w") as out:
        out.write(f"{f}\n{layout.fu}\n{layout.fv}\n{k}\n")
        for d in layout.Du:
            out.write(f"{d}\n")
        for d in layout.Dv:
            out.write(f"{d}\n")

    def native_write(name, b, tbl) -> bool:
        try:
            from .data.native_io import write_block_native

            return write_block_native(path, name, b.f1, b.f2, tbl)
        except Exception:
            return False

    for b in layout.all_blocks():
        for name in ("W", "H"):
            tbl = np.asarray(params[b.f12][name], dtype=np.float64)
            if native_write(name, b, tbl):
                continue
            with open(path, "a") as out:
                for row in range(tbl.shape[0]):
                    vals = " ".join(_fmt_g(x) for x in tbl[row])
                    out.write(f"{name},{b.f1},{b.f2},{row} {vals}\n")


def _fmt_g(x: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(x):.6g}"


def load_text_model(path: str):
    """Parse the text model back into (layout metadata, params).

    Dispatches the body (the multi-GB part on production models) to the C++
    reader (native/parser.cpp ocffm_read_model) when built, falling back to
    the pure-Python parser."""
    with open(path) as fh:
        header: List[str] = []
        while True:
            header.append(fh.readline())
            # f, fu, fv, k read first; then fu+fv dim lines
            if len(header) >= 4:
                fu = int(header[1])
                fv = int(header[2])
                if len(header) == 4 + fu + fv:
                    break
        offset = fh.tell()
    f = int(header[0])
    fu = int(header[1])
    fv = int(header[2])
    k = int(header[3])
    Du = [int(header[4 + i]) for i in range(fu)]
    Dv = [int(header[4 + fu + i]) for i in range(fv)]

    flat = None
    try:
        from .data.native_io import read_model_body_native

        flat = read_model_body_native(path, offset, k)
    except Exception:
        flat = None

    tables: Dict[Tuple[str, int, int], Dict[int, Any]] = {}
    if flat is not None:
        names, bf1, bf2, brow, vals = flat
        # group rows into block tables (vectorized: sort by block key)
        for code, nm in ((0, "W"), (1, "H")):
            msk = names == code
            keys = bf1[msk].astype(np.int64) * (f + 1) + bf2[msk]
            rows_b = brow[msk]
            vals_b = vals[msk]
            for key in np.unique(keys):
                sel = keys == key
                f1i, f2i = int(key // (f + 1)), int(key % (f + 1))
                d = int(rows_b[sel].max()) + 1
                arr = np.zeros((d, k))
                arr[rows_b[sel]] = vals_b[sel]
                tables[(nm, f1i, f2i)] = arr
    else:
        with open(path) as fh:
            fh.seek(offset)
            acc: Dict[Tuple[str, int, int], Dict[int, List[float]]] = {}
            for ln in fh:
                ln = ln.strip()
                if not ln:
                    continue
                head, v = ln.split(" ", 1)
                name, f1s, f2s, row = head.split(",")
                key = (name, int(f1s), int(f2s))
                acc.setdefault(key, {})[int(row)] = [float(x) for x in v.split()]
        for key, rows in acc.items():
            d = max(rows) + 1
            arr = np.zeros((d, k))
            for r, v in rows.items():
                arr[r] = v
            tables[key] = arr

    # reconstruct self_side from which blocks exist
    self_side = any(
        (f1 < fu and f2 < fu) or (f1 >= fu and f2 >= fu)
        for (_, f1, f2) in tables.keys()
    )
    layout = BlockLayout.make(Du, Dv, self_side)
    params: Dict[int, Dict[str, np.ndarray]] = {}
    for b in layout.all_blocks():
        params[b.f12] = {
            "W": tables[("W", b.f1, b.f2)],
            "H": tables[("H", b.f1, b.f2)],
        }
    return layout, k, params


# ---------------------------------------------------------------------------
# Native checkpointing (capability the reference lacks: resume mid-training)
# ---------------------------------------------------------------------------


def save_checkpoint(
    ckpt_dir: str,
    params: Dict[int, Dict[str, np.ndarray]],
    epoch: int,
    cfg: TrainConfig,
    layout: Optional[Dict] = None,
):
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    def storable(v: np.ndarray) -> np.ndarray:
        # np.load round-trips ml_dtypes.bfloat16 as an opaque |V2 void dtype
        # (no cast function) — store non-native float dtypes as f32 (lossless
        # upcast from bf16).  Native f32/f64 keep their precision.
        if v.dtype in (np.float32, np.float64):
            return v
        return np.asarray(v, np.float32)

    for f12, blk in params.items():
        arrays[f"W_{f12}"] = storable(blk["W"])
        arrays[f"H_{f12}"] = storable(blk["H"])
    tmp = os.path.join(ckpt_dir, ".ckpt.tmp.npz")
    np.savez(tmp, epoch=np.int64(epoch), **arrays)
    os.replace(tmp, os.path.join(ckpt_dir, "ckpt.npz"))
    doc = dataclasses.asdict(cfg)
    if layout is not None:
        doc["layout"] = layout
    with open(os.path.join(ckpt_dir, "config.json"), "w") as fh:
        json.dump(doc, fh, indent=2)


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "ckpt.npz"))


def load_checkpoint(ckpt_dir: str):
    z = np.load(os.path.join(ckpt_dir, "ckpt.npz"))
    params: Dict[int, Dict[str, np.ndarray]] = {}
    for key in z.files:
        if key == "epoch":
            continue
        name, f12 = key.split("_")
        v = z[key]
        if v.dtype.kind == "V" and v.dtype.itemsize == 2:
            # legacy checkpoint written with bf16 tables: numpy loads the
            # ml_dtypes.bfloat16 descr as an opaque 2-byte void — reinterpret
            import ml_dtypes

            v = v.view(ml_dtypes.bfloat16).astype(np.float32)
        params.setdefault(int(f12), {})[name] = v
    return params, int(z["epoch"])
