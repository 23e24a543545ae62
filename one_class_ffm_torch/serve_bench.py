"""Serving-path throughput of the port: full-catalog scoring + top-K,
hard-synced.

    python -m one_class_ffm_torch.serve_bench [--platform cuda|cpu]

The counterpart of ``scripts/serve_bench.py``, with its knobs and defaults
(environment: ``SB_USERS`` 200,704, ``SB_ITEMS`` 20,224, ``SB_K`` 32,
``SB_CHUNK`` 4096, ``SB_TOPK`` 10, ``SB_REPS`` 3): two cross blocks plus the
item sums ``bt``, random normal tables from a seeded generator, bfloat16 on
the card and float32 on the CPU.  Each chunk of users is scored against the
whole catalog and ranked with predict's tie-exact top-K (``rank_topk``:
the lowest id first among equal scores: on the card its top-K kernel,
which reads the bfloat16 scores in place, on the CPU the stable
descending sort).  A pass ends in
``torch.cuda.synchronize()`` and a host scalar fetch inside the timed
window; the metric is the best of ``SB_REPS`` passes after one warm-up.

``torch.topk`` on the same scores (no tie order) is timed the same way as
the library yardstick and printed on its own line; the last line is the
metric's JSON object, with the original's keys plus ``backend`` and
``device`` (on the card its name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .predict import rank_topk
from .utils.device import card_line, resolve_device


def knobs():
    """The original's environment knobs, with its defaults."""
    env = os.environ.get
    return dict(n_users=int(env("SB_USERS", 200_704)),
                n_items=int(env("SB_ITEMS", 20_224)),
                k=int(env("SB_K", 32)), chunk=int(env("SB_CHUNK", 4096)),
                topk=int(env("SB_TOPK", 10)), reps=int(env("SB_REPS", 3)))


def tables(n_users: int, n_items: int, k: int, device, dtype, seed: int = 0):
    """(P1, P2, Q1, Q2, bt): two cross blocks' user and item projections and
    the item sums, standard normal from ``seed``, stored at ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return (normal(n_users, k), normal(n_users, k), normal(n_items, k),
            normal(n_items, k), normal(n_items))


def score_all(P1, P2, Q1, Q2, bt, chunk: int, topk: int, rank=None):
    """(users // chunk * chunk, topk) ids: each chunk's scores
    P1 Q1^T + P2 Q2^T + bt ranked by ``rank`` (z, topk) -> ids, predict's
    tie-exact top-K by default."""
    rank = rank or (lambda z, t: rank_topk(z, t)[1])
    n_chunks = P1.shape[0] // chunk
    out = torch.zeros((n_chunks * chunk, topk), dtype=torch.int64,
                      device=P1.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        z = P1[sl] @ Q1.T + P2[sl] @ Q2.T + bt[None, :]
        out[sl] = rank(z, topk)
    return out


def timed_passes(fn, reps: int, device):
    """Seconds of each of ``reps`` passes after one warm-up pass, each
    ended by a device sync and a host scalar fetch."""
    def one():
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        int(out[0, 0])

    one()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    return times


def run(device, n_users: int, n_items: int, k: int, chunk: int, topk: int,
        reps: int):
    """(metric record, yardstick record, ids) of one run."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    P1, P2, Q1, Q2, bt = tables(n_users, n_items, k, device, dtype)
    ids = None

    def ours():
        nonlocal ids
        ids = score_all(P1, P2, Q1, Q2, bt, chunk, topk)
        return ids

    def library():
        return score_all(P1, P2, Q1, Q2, bt, chunk, topk,
                         rank=lambda z, t: torch.topk(z, t).indices)

    times = timed_passes(ours, reps, device)
    lib_times = timed_passes(library, reps, device)
    n = P1.shape[0] // chunk * chunk
    where = card_line() if device.type == "cuda" else "cpu"
    backend = (f"torch {torch.__version__} "
               + (f"cuda {torch.version.cuda}" if device.type == "cuda"
                  else "cpu") + f", {str(dtype).replace('torch.', '')}")
    best = min(times)
    rec = {
        "metric": "serving_users_per_sec",
        "value": round(n / best, 1),
        "catalog": n_items,
        "pair_scores_per_sec": round(n * n_items / best, 1),
        "segments_users_per_sec": [round(n / t, 1) for t in times],
        "backend": backend,
        "device": where,
    }
    lib = {
        "yardstick": "torch.topk (no tie order), same scores",
        "users_per_sec": round(n / min(lib_times), 1),
        "segments_users_per_sec": [round(n / t, 1) for t in lib_times],
        "device": where,
    }
    return rec, lib, ids


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m one_class_ffm_torch.serve_bench",
        description="full-catalog scoring + tie-exact top-K throughput "
                    "(knobs: SB_USERS, SB_ITEMS, SB_K, SB_CHUNK, SB_TOPK, "
                    "SB_REPS)")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        p.error("--platform cuda: no CUDA device is available "
                "(pass --platform cpu to run on the CPU)")
    device = resolve_device(args.platform)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
    rec, lib, _ = run(device, **knobs())
    print(json.dumps(lib))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
