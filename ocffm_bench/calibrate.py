"""Readings that the limits of ``limits/<workload>.json`` are set from; not
run by the benchmark's own runs.

    python3 ocffm_bench/calibrate.py <workload> <seed> [<seed> ...] \
        [--variants program,control_tf32,...]

Each reading is one run of the cell's own driver (``harness.run_driver``)
at the cell's own size, with a window of one job (training) or of
``check_requests`` requests served back to back (ranking), judged by the
driver's own comparison; a variant plants its change through the driver's
hooks:

- ``program``: the program as it is (the lower readings; for ranking also
  the capacity, the mean service time of requests served back to back);
- ``control_tf32``: the reference in the program's place at the precision
  below the configuration's float32 with TF32 off.  Training: the tables
  that the comparison takes are the float32 reference's with every
  product's operands rounded to TF32 (``Reference(tf32=True)``); ranking:
  each request's ids are those of the float32 reference's scores with
  TF32 matmuls, ranked by a stable sort;
- ``fault_half_positives`` (training): the program is handed every other
  positive only.

One JSON line per seed and variant.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ocffm_bench import gen, harness  # noqa: E402
from ocffm_bench.drivers import train as train_driver  # noqa: E402
from ocffm_bench.reference.ffm_ref import Reference, start_tables  # noqa
from ocffm_bench.reference.rank_ref import RankReference  # noqa: E402

VARIANTS = {"train": ("program", "control_tf32", "fault_half_positives"),
            "rank": ("program", "control_tf32")}


class tf32:
    """TF32 matmuls switched on inside the block."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def half_positives(problem: gen.Problem) -> gen.Problem:
    keep = np.arange(problem.pos_u.shape[0]) % 2 == 0
    return gen.Problem(problem.users, problem.items, problem.pos_u[keep],
                       problem.pos_v[keep], problem.popular,
                       problem.user_label, problem.item_label)


def train_hooks(ctx: harness.Context, variant: str) -> dict:
    if variant == "fault_half_positives":
        return {"program_problem": half_positives}
    if variant != "control_tf32":
        return {}

    def outputs(outs, problem, init):
        ref = Reference(problem, train_driver.hyper(ctx.config), ctx.device,
                        torch.float32, tf32=True)
        low, cur = [], ref.cast(init)
        for _ in outs:
            cur, _ = ref.epoch(cur)
            low.append({f: {n: t.float().cpu() for n, t in b.items()}
                        for f, b in cur.items()})
        return low
    return {"outputs": outputs}


def rank_hooks(ctx: harness.Context, variant: str) -> dict:
    if variant != "control_tf32":
        return {}
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    made = {}

    def served(r, users, ids):
        if "ref" not in made:
            problem = gen.make_problem(cfg, traffic, ctx.seed,
                                       with_positives=False)
            made["ref"] = RankReference(
                problem, start_tables(problem, bool(cfg["self_side"]),
                                      int(cfg["k"]), gen.STRUCTURE_SEED, dev),
                bool(cfg["self_side"]), dev, torch.float32)
        with tf32():
            z = made["ref"].scores(users)
        top = torch.sort(z, dim=1, descending=True, stable=True).indices
        return top[:, :int(traffic["top_k"])].cpu().numpy()
    return {"served": served}


def context(workload: str, seed: int, device="cuda:0") -> harness.Context:
    return harness.make_context(workload, seed, 1e-3, False, device,
                                time.perf_counter())[2]


def reading(ctx: harness.Context, variant: str) -> dict:
    """One run of ``ctx``'s cell with ``variant`` planted."""
    t0 = time.perf_counter()
    kind = ctx.traffic["driver"]
    detail: list = []
    if kind == "train":
        ctx.hooks.update(train_hooks(ctx, variant), detail=detail)
    else:
        ctx.traffic["rate_per_s"] = 1e6  # back to back: the capacity
        ctx.seconds = int(ctx.traffic["check_requests"]) / 1e6
        ctx.hooks.update(rank_hooks(ctx, variant))
    res = harness.run_driver(ctx)
    out = dict(workload=ctx.workload, seed=ctx.seed, variant=variant,
               correct=all(c.ok for c in res.checks) and res.failed == 0,
               numbers=res.run["numbers"])
    if kind == "train":
        out.update(cg_iters=res.run["cg_iters"][:len(detail)],
                   reference_cg_iters=res.run["reference_cg_iters"],
                   detail=detail)
    elif variant == "program":
        svc = np.asarray(res.run["service_s"])
        out.update(service_ms_mean=1e3 * float(svc.mean()),
                   service_ms_p95=1e3 * float(np.percentile(svc, 95)),
                   capacity_per_s=1.0 / float(svc.mean()))
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--variants", default="",
                    help="comma-separated; default: every variant of the "
                    "cell's driver")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    kind = context(args.workload, 0, "cpu").traffic["driver"]
    variants = [v for v in args.variants.split(",") if v] or VARIANTS[kind]
    for seed in args.seeds:
        for variant in variants:
            print(json.dumps(reading(context(args.workload, seed), variant)),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
