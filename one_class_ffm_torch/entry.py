"""The scoring entry point of the PyTorch port.

The counterpart of ``__graft_entry__.entry()``: ``entry()`` returns a
forward scoring step on the flagship model (one-class FFM scoring: padded
user features -> full-catalog scores) and example arguments for it, built
by the port's own data assembly and solver init at the sizes of
``__graft_entry__._make_problem`` (64 users x 32 items, fields of 64 + 24
and 32 + 16 features, k=8, self blocks).

    fn, args = entry()          # on the card; entry("cpu") on the CPU
    z = fn(*args)               # (64, 32) scores

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: one sharded training epoch, a sharded
evaluation and an item-sharded top-K through the Trainer on a 1-D ``n``-rank
data mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.synth import SynthSpec, build_padded
from .models.blocks import BlockLayout
from .predict import catalog_scores, project_users
from .solver.params import HyperParams
from .solver.torch_solver import FFMSolver, make_device_data


def _make_problem(device, row_multiple: int = 8, n_users: int = 64,
                  n_items: int = 32):
    spec = SynthSpec(
        n_users=n_users, n_items=n_items, avg_pos=4.0, seed=0,
        dims_u=(n_users, 24), dims_v=(n_items, 16),
    )
    (du, dv), u_pad, v_pad, y_pad = build_padded(
        spec, dtype=np.float32, row_multiple=row_multiple)
    layout = BlockLayout.make(du, dv, self_side=True)
    hp = HyperParams(k=8, lam=0.01, omega=0.1, r=-1.0)
    return make_device_data(u_pad, v_pad, y_pad, layout, hp,
                            dtype=torch.float32, device=device)


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the forward scoring step on one device.

    fn(params, xu_idx, xu_val, Q, bt) -> (batch, n_items) scores:
    per-field embedding projections P = X W (B8 on the card), then
    z = bt + sum_c P_c Q_c^T (the reference's pred_z, ffm.cpp:915-923,
    batched)."""
    meta, data = _make_problem(device)
    solver = FFMSolver(meta, data)
    gen = torch.Generator(device=solver.device).manual_seed(0)
    state = solver.init(gen)
    layout = meta.layout

    def fn(params, xu_idx, xu_val, Q, bt):
        return catalog_scores(layout,
                              project_users(layout, params, xu_idx, xu_val),
                              Q, bt)

    example_args = (state["params"], data["xu_idx"], data["xu_val"],
                    state["Q"], state["b"])
    return fn, example_args



def _dryrun_rank(device: str, n_devices: int):
    """One rank of ``dryrun_multichip``: its own copy of the dataset (the
    same files on every rank, from the seed), one epoch, one evaluation,
    one top-5 on the mesh (``n_devices // 2 x 2`` at 4 or more, an even
    count, its tables of 8 rows or more row-sharded on the model axis);
    returns what it checked."""
    import math
    import tempfile

    from .data.synth import SynthSpec, write_dataset
    from .train import TrainConfig, Trainer

    with tempfile.TemporaryDirectory() as td:
        item, train, va = write_dataset(
            td, SynthSpec(n_users=64, n_items=32, avg_pos=4.0, seed=0,
                          dims_u=(64, 24), dims_v=(32, 16)))
        two_d = n_devices >= 4 and n_devices % 2 == 0
        cfg = TrainConfig(item_path=item, train_path=train, test_path=va,
                          k=8, lam=0.01, omega=0.1, nr_pass=1, eval_every=1,
                          mesh_shape=(f"{n_devices // 2}x2" if two_d
                                      else str(n_devices)),
                          model_min_rows=8, distributed=True,
                          eval_shard="items", blocked_bm=8)
        trainer = Trainer(cfg, device=device)
        metrics = trainer.run(log=lambda *_: None)
        mesh = trainer.mesh
        assert mesh is not None and mesh.size * mesh.n_model == n_devices
        # the training state stayed distributed: this rank's rows only
        assert trainer.state["a"].shape[0] == trainer.meta.m // mesh.size
        dims = {b.f12: dict(W=b.d1, H=b.d2)
                for b in trainer.data.layout.all_blocks()}
        sharded = [f"{name}[{f12}]" for f12, blk in trainer.state[
            "params"].items() for name, t in blk.items()
            if t.shape[0] < trainer.meta.pad_d(dims[f12][name])]
        assert sharded or not two_d, "no table sharded on the model axis"
        loss = float(trainer.solver.objective(trainer.state))
        assert math.isfinite(loss), "objective is not finite"
        assert metrics and math.isfinite(metrics["ploss"])
        assert trainer.evaluator.shard_by == "items"
        top = trainer.predict_topk(k=5)
        assert top.shape == (len(trainer.data.va_labels), 5), top.shape
        return dict(rank=mesh.rank, model_rank=mesh.model_rank,
                    objective=loss, ploss=metrics["ploss"],
                    top_shape=top.shape, sharded=sharded)


def dryrun_multichip(n_devices: int,
                     device: torch.device | str = "cuda") -> list:
    """One sharded training epoch (gradients, CG and Newton steps of every
    field-pair block), a sharded evaluation and an item-sharded
    ``predict_topk(k=5)`` through the Trainer on a tiny synthetic dataset,
    on the JAX package's mesh (``__graft_entry__.dryrun_multichip``): at 4
    or more ranks, an even count, the ``n_devices // 2 x 2`` data x model
    mesh with ``model_min_rows=8``, else the 1-D ``n_devices``-rank data
    mesh; asserts that the state stays distributed (on the 2-D mesh a
    table row-sharded on the model axis), the objective and metrics are
    finite and the top-K has its shape.  Inside a process group of
    ``n_devices`` ranks it runs this rank; otherwise it spawns
    ``n_devices`` gloo ranks on ``device`` (which may be one card that they
    share).  Returns each rank's summary (this rank's alone inside a
    group)."""
    import torch.distributed as dist

    from .parallel.distributed import spawn

    if dist.is_available() and dist.is_initialized():
        return [_dryrun_rank(str(device), n_devices)]
    return spawn(_dryrun_rank, n_devices, args=(str(device), n_devices),
                 backend="gloo")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    for out in dryrun_multichip(2):
        print("dryrun_multichip(2) rank", out["rank"], "ok:", out)
