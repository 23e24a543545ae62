"""Ranking traffic: requests of ``batch_users`` users, each ranked over the
whole catalog for its top ``top_k`` items, offered in an open loop.

Set-up makes the features and the configuration's tables on the card from
the seed, runs predict's ``item_side`` once, draws every request's users
and serves ``warmup_requests`` requests.  Request r is due at
``r / rate_per_s`` seconds into the window; it is served when it is due or,
behind a late one, when that one is done, through predict's four
functions in the order of predict's own loop (``project_users``,
``catalog_scores``, the cold users' ``where``, ``rank_topk``) and the
copy of its ids to the host.  Its latency runs from when it was due to
when its ids are on the host; ``rank_p95_ms`` is the 95th percentile over
every request due in the window.  Once the window has closed, a sample of
the served requests drawn from the seed is judged against the float64
reference (``reference/rank_ref.py``).

Hook (``ctx.hooks``, for the tests and ``calibrate.py``): ``served(r,
users, ids)`` returns the ids that stand as request r's answer.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from .. import gen, trace, work
from ..harness import Check, Context, DriverResult
from ..reference.ffm_ref import start_tables
from ..reference.rank_ref import RankReference


SLACK_S = 0.005


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest rank."""
    xs = sorted(values)
    return float(xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)])


def run(ctx: Context) -> DriverResult:
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.predict import (catalog_scores, item_side,
                                             project_users, rank_topk)

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    batch, top_k = int(traffic["batch_users"]), int(traffic["top_k"])
    rate = float(traffic["rate_per_s"])
    problem = gen.make_problem(cfg, traffic, ctx.seed, with_positives=False)
    users, items = problem.users, problem.items
    self_side = bool(cfg["self_side"])
    tables = start_tables(problem, self_side, int(cfg["k"]),
                          gen.STRUCTURE_SEED, dev)
    layout = BlockLayout.make(users.dims, items.dims, self_side)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Q, bt = item_side(layout, tables, [to_dev(a) for a in items.idx],
                      [to_dev(a) for a in items.val])
    pop_t = to_dev(problem.popular.astype(np.float32))
    cold_all = (sum((v != 0).sum(axis=1) for v in users.val) == 0)
    catalog = items.rows
    rng = np.random.default_rng([int(ctx.seed), 1])
    n_due = int(math.ceil(ctx.seconds * rate))
    warm = int(traffic["warmup_requests"])
    req_users = rng.integers(0, users.rows, size=(warm + n_due, batch))
    alter = ctx.hooks.get("served", lambda r, u, ids: ids)
    spans = ctx.spans

    def serve(r: int) -> np.ndarray:
        ids = req_users[r]
        with spans.span("request"):
            idx, val = gen.rows_of(users, ids)
            with spans.span("project_users"):
                P = project_users(layout, tables, [to_dev(a) for a in idx],
                                  [to_dev(a) for a in val])
            with spans.span("catalog_scores"):
                z = catalog_scores(layout, P, Q, bt)
            with spans.span("cold_where"):
                z = torch.where(to_dev(cold_all[ids])[:, None],
                                pop_t[None, :], z)
            with spans.span("rank_topk"):
                _, top = rank_topk(z[:, :catalog], top_k)
            with spans.span("to_host"):
                out = top.cpu().numpy()
        return alter(r, ids, out)

    for r in range(warm):
        serve(r)
    sync()

    served = {}
    lat, service, late = [], [], []
    digest = None
    prof = trace.profiler() if ctx.traced else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    for i in range(n_due):
        due = t0 + i / rate
        now = time.perf_counter()
        if now < due:
            # sleep to SLACK_S short of the due time, spin the rest: a
            # sleep alone wakes late by up to milliseconds
            with spans.span("wait_due"):
                if due - now > SLACK_S:
                    time.sleep(due - now - SLACK_S)
                while time.perf_counter() < due:
                    pass
        start = time.perf_counter()
        served[warm + i] = serve(warm + i)
        done = time.perf_counter()
        lat.append(done - due)
        service.append(done - start)
        late.append(start - due)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        digest = trace.digest(prof)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run_info = dict(requests=n_due, window_s=window_s, service_s=service,
                    digest=digest, batch=batch)
    print(f"generator late: p95 {percentile(late, 95.0) * 1e3:.4f} ms, "
          f"max {max(late) * 1e3:.4f} ms; service p50 "
          f"{percentile(service, 50.0) * 1e3:.4f} ms", file=sys.stderr,
          flush=True)
    if digest is not None:
        c = work.Counter(work.load_peaks(torch.cuda.get_device_name(dev)))
        work.rank_request_work(work.shape_of(cfg, 0), batch, top_k, c)
        run_info.update(bound_s=c.seconds)

    # the comparison, with the program's tensors freed
    del Q, bt, pop_t, tables
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_tables = start_tables(problem, self_side, int(cfg["k"]),
                              gen.STRUCTURE_SEED, dev)
    ref = RankReference(problem, ref_tables, self_side, dev, torch.float64)
    del ref_tables
    pick = np.random.default_rng([int(ctx.seed), 2]).choice(
        sorted(served), size=min(int(traffic["check_requests"]),
                                 len(served)), replace=False)
    gap, bad = 0.0, 0
    for r in pick:
        res = ref.judge(req_users[r], served[r])
        gap, bad = max(gap, res["gap"]), bad + res["bad_ids"]
    checks = [Check("rank_gap", gap, float(ctx.limits["rank_gap"])),
              Check("bad_id_rows", float(bad),
                    float(ctx.limits["bad_id_rows"]))]
    run_info.update(numbers={c.name: c.value for c in checks})
    return DriverResult(
        end_to_end=dict(rank_p95_ms=percentile(lat, 95.0) * 1e3,
                        setup_s=setup_s),
        checks=checks, attempted=n_due, failed=n_due - len(served),
        memory_peak_bytes=peak, run=run_info)
