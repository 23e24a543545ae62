"""End-to-end trainer of the PyTorch port.

Counterpart of ``one_class_ffm_tpu/train.py`` on one device.  The host-side
pieces are the JAX package's own and are imported, not copied: the run
configuration (``TrainConfig``), the data pipeline (``load_problem``), the
text model and npz checkpoint formats, and the header / log-row / JSONL
formatting — so the port's output is byte-compatible with the reference's
log tools.

``dtype="auto"`` means float32 here on every device, until bfloat16 storage
is measured on the GPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from one_class_ffm_tpu.train import (  # noqa: F401  (re-exported)
    TOP_KS,
    LoadedData,
    NonFiniteMetricError,
    TrainConfig,
    _lcm,
    has_checkpoint,
    load_checkpoint,
    load_problem,
    load_text_model,
    save_checkpoint,
    save_text_model,
)
from one_class_ffm_tpu.train import Trainer as _ReferenceTrainer
from one_class_ffm_tpu.utils.profiling import PhaseTimer

from .evalx.torch_eval import Evaluator, make_eval_data
from .solver.convert import params_from_numpy, params_to_numpy
from .solver.torch_solver import FFMSolver, make_device_data

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    """Storage dtype by name; "auto" is float32 (bfloat16 has not been
    measured on the GPU yet)."""
    return torch.float32 if name == "auto" else _DTYPES[name]


def resolve_device(device: torch.device | str) -> torch.device:
    """The run's device; a CUDA device that is not there is an error, never
    a quiet switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but "
                               "torch.cuda.is_available() is False")
        # f32 matmuls must be true f32 (the reference requests HIGHEST)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class Trainer:
    """Owns the solver + evaluator for one run on one device."""

    # log formats: the reference trainer's own functions
    describe = _ReferenceTrainer.describe
    _print_header = _ReferenceTrainer._print_header
    _format_row = _ReferenceTrainer._format_row
    _write_jsonl = _ReferenceTrainer._write_jsonl

    def __init__(self, cfg: TrainConfig, data: Optional[LoadedData] = None,
                 device: torch.device | str = "cuda"):
        if cfg.mesh_shape or cfg.distributed:
            raise NotImplementedError(
                "--mesh / --distributed (multi-device runs): ROADMAP A11")
        if cfg.ckpt_format != "npz":
            raise NotImplementedError(
                f"--ckpt-format {cfg.ckpt_format} (JAX-only): the port "
                "writes npz checkpoints")
        if cfg.profile_dir:
            raise NotImplementedError("--profile-dir (traces): ROADMAP A12")
        self.device = resolve_device(device)
        if cfg.blocked_bm > 0:
            # user and item rows must divide the block size
            cfg = dataclasses.replace(
                cfg, row_multiple=_lcm(max(1, cfg.row_multiple),
                                       cfg.blocked_bm))
        self.cfg = cfg
        self.data = data if data is not None else load_problem(cfg)
        d = self.data
        self.dtype = resolve_dtype(cfg.dtype)
        self.meta, dev = make_device_data(
            d.u_pad, d.v_pad, d.y_pad, d.layout, cfg.hyper(),
            dtype=self.dtype, blocked_bm=cfg.blocked_bm, device=self.device)
        self.solver = FFMSolver(self.meta, dev)
        self.evaluator = None
        if d.uva_pad is not None and d.va_labels:
            emeta, edata = make_eval_data(
                d.uva_pad, d.va_labels, d.popular, n_items=d.v_pad.m,
                n_items_true=d.n_items_true, layout=d.layout,
                dtype=self.dtype, top_ks=TOP_KS, device=self.device)
            self.evaluator = Evaluator(emeta, edata, chunk=cfg.eval_chunk)
        self.state = None
        self.epoch_idx = 0
        # bf16's incremental bookkeeping drift is reset periodically
        # (TrainConfig.refresh_every)
        if cfg.refresh_every is not None:
            self.refresh_every = int(cfg.refresh_every)
        else:
            self.refresh_every = 10 if self.dtype == torch.bfloat16 else 0
        self.timer = PhaseTimer()
        # per trained epoch: {"epoch", "seconds", "cg_iters"} (the per-solve
        # CG iteration counts in epoch_order, f1 then f2 half of each block)
        self.history: List[Dict[str, Any]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- lifecycle ------------------------------------------------------------

    def init_state(self):
        cfg = self.cfg
        if cfg.resume and cfg.ckpt_dir and has_checkpoint(cfg.ckpt_dir):
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
            {"params": params_from_numpy(params_np, self.device, self.dtype)})

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
        params_np, epoch = load_checkpoint(self.cfg.ckpt_dir)
        self._load_params(params_np)
        self.epoch_idx = epoch

    def save_checkpoint(self):
        lay = self.data.layout
        layout_doc = dict(fu=lay.fu, fv=lay.fv, Du=list(lay.Du),
                          Dv=list(lay.Dv), self_side=lay.self_side)
        save_checkpoint(self.cfg.ckpt_dir, self.params_numpy(),
                        self.epoch_idx, self.cfg, layout=layout_doc)

    # -- training loop --------------------------------------------------------

    def run(self, log=print) -> Dict[str, float]:
        """Full solve loop (reference solve(), ffm.cpp:1147-1161)."""
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        self._print_header(log)
        metrics: Dict[str, float] = {}
        while self.epoch_idx < cfg.nr_pass:
            self._sync()
            t0 = time.perf_counter()
            with self.timer.phase("epoch"):
                self.state, iters = self.solver.epoch_stats(self.state)
                self._sync()
            self.epoch_idx += 1
            t_epoch = time.perf_counter() - t0
            self.history.append(dict(epoch=self.epoch_idx, seconds=t_epoch,
                                     cg_iters=iters.tolist()))
            if self.refresh_every and self.epoch_idx % self.refresh_every == 0:
                with self.timer.phase("refresh"):
                    self.state = self.solver.refresh_caches(
                        {"params": self.state["params"]})
            if (self.evaluator is not None
                    and self.epoch_idx % cfg.eval_every == 0):
                with self.timer.phase("validate"):
                    metrics = self.validate()
                self._check_finite(metrics)
                log(self._format_row(self.epoch_idx, metrics))
                self._write_jsonl(self.epoch_idx, metrics, t_epoch)
            if cfg.ckpt_dir and self.epoch_idx % cfg.eval_every == 0:
                with self.timer.phase("checkpoint"):
                    self.save_checkpoint()
        if cfg.model_path:
            save_text_model(cfg.model_path, self.params_numpy(),
                            self.data.layout, cfg.k)
        if cfg.ckpt_dir:
            self.save_checkpoint()
        if cfg.timing:
            self.timer.report(log)
        return metrics

    def validate(self) -> Dict[str, float]:
        if self.evaluator is None:
            raise RuntimeError("no test set: construct with cfg.test_path")
        st = self.state
        return self.evaluator.validate(st["params"], st["Q"], st["b"])

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

    # -- io -------------------------------------------------------------------

    def params_numpy(self):
        """Host copies of the block tables at their true field dims."""
        dims = {b.f12: (b.d1, b.d2) for b in self.data.layout.all_blocks()}
        return {f12: {"W": blk["W"][: dims[f12][0]],
                      "H": blk["H"][: dims[f12][1]]}
                for f12, blk in params_to_numpy(self.state["params"]).items()}

    def predict_topk(self, k: int = 10, chunk: int = 1024) -> np.ndarray:
        """Top-k item ids for every test user (cold users ranked by
        popularity; ties to the lowest id), using the current parameters."""
        if self.evaluator is None:
            raise RuntimeError("no test set: construct with cfg.test_path")
        ev = self.evaluator
        Pva, _ = ev._project_users(self.state["params"])
        meta = ev.meta
        outs = []
        for lo in range(0, meta.mt_true, chunk):
            sl = slice(lo, min(lo + chunk, meta.mt_true))
            z = ev.scores({f12: P[sl] for f12, P in Pva.items()},
                          ev.data["cold"][sl], self.state["Q"],
                          self.state["b"])[:, : meta.catalog]
            top = torch.sort(z, dim=1, descending=True, stable=True).indices
            outs.append(top[:, :k].cpu().numpy())
        return np.concatenate(outs, axis=0)
