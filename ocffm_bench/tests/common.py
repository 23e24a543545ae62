"""Tiny cells for the CPU tests: the real configurations and mixes with
their scale cut, run through the same drivers on the CPU."""

import json
import os
import time

from ocffm_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_context(workload: str, seed: int = 5, traced: bool = False,
                 hooks=None) -> harness.Context:
    _, _, ctx = harness.make_context(workload, seed, 0.5, traced, "cpu",
                                     time.perf_counter(), hooks=hooks)
    cfg = ctx.config
    cfg.update(users=240, items=600, k=8, blocked_bm=16)
    if len(cfg["item_fields"]) > 1:
        cfg["item_fields"][1]["groups"] = [5, 40, 3]
    cfg["positives_per_user"]["mean"] = 15.0
    ctx.traffic.update(epochs_per_job=3, batch_users=32, check_requests=4,
                       rate_per_s=40.0)
    return ctx


def load(path: str) -> dict:
    with open(os.path.join(BENCH, path)) as fh:
        return json.load(fh)
