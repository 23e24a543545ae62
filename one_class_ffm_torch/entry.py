"""The scoring entry point of the PyTorch port.

The counterpart of ``__graft_entry__.entry()``: ``entry()`` returns a
forward scoring step on the flagship model (one-class FFM scoring: padded
user features -> full-catalog scores) and example arguments for it, built
by the port's own data assembly and solver init at the sizes of
``__graft_entry__._make_problem`` (64 users x 32 items, fields of 64 + 24
and 32 + 16 features, k=8, self blocks).

    fn, args = entry()          # on the card; entry("cpu") on the CPU
    z = fn(*args)               # (64, 32) scores
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


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
