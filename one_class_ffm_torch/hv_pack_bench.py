"""The Hv-variant comparison of scripts/hv_pack_bench.py, on the GPU.

    python -m one_class_ffm_torch.hv_pack_bench [--platform cuda|cpu]

The per-CG-iteration cross Hv pass (B1, ``pos_hv_blocked``) against its two
variants on the same stream:

    packed   B9 ``pos_hv_packed``: the stream lane-packed four k = 32 entries
             per 128-wide row, as the TPU experiment laid it out
    g2       B10 ``pos_hv_blocked_g`` at G = 2 blocks per CTA (the only G of
             the original's {2, 4, 8} that divides its 782 blocks)

plus the per-solve relayouts each needs: the row gather of B1 and B10
(``gather_blocked_rows``) against ``pack_stream`` (the gather, then the
packing).  The stream is the original's synthetic one, drawn with numpy
from seed 0: 782 blocks of 256 rows, MAXC 1376, k = 32, rows gathered from
a 20,224-row table, w_scale 0.9.  Every variant is checked against the
plain B1 first (it must give B1's bits), then timed by CUDA events (median
of 5 rounds of 10 back-to-back calls), at bfloat16 (the original's dtype
on the chip) and at float32.  The last line printed is one JSON object.

On the CPU (``--platform cpu``) it runs a correctness pass on the plain
versions at the original's CPU shapes (8 blocks, MAXC 64, 512 table rows),
float32, and times nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from .ops import kernels
from .ops import sparse_ops as ops
from .ops.layout import row_runs

BM, K, W_SCALE = 256, 32, 0.9
CARD_SHAPE = dict(n_blocks=782, maxc=1376, b_rows=20224)
CPU_SHAPE = dict(n_blocks=8, maxc=64, b_rows=512)
GROUPS = (2, 4, 8)  # the original's G values; those dividing n_blocks run


def make_stream(n_blocks: int, maxc: int, b_rows: int, seed: int = 0):
    """The original's synthetic inputs as numpy arrays, drawn in its order:
    sorted owners (the pad marker BM included), the pad mask as weights,
    the gather ids, the table B, phi and the dense matrix."""
    rng = np.random.default_rng(seed)
    own = rng.integers(0, BM + 1, size=(n_blocks, maxc)).astype(np.int32)
    own.sort(axis=1)
    w = (own < BM).astype(np.float32)
    take = rng.integers(0, b_rows, size=(n_blocks, maxc)).astype(np.int32)
    B = rng.normal(size=(b_rows, K))
    phi = rng.normal(size=(n_blocks * BM, K))
    dmat = rng.normal(size=(K, K)) * 0.1
    return dict(own=own, w=w, take=take, B=B, phi=phi, dmat=dmat)


def _time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over rounds of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err / scale if scale > 0 else err


def run(device: torch.device, dtype: torch.dtype, shape: dict,
        timed: bool) -> dict:
    """Check B1, B9 and B10 against the plain B1 on one stream, then (if
    ``timed``) time them and the two relayouts.  Returns the results."""
    s = make_stream(**shape)
    nb = shape["n_blocks"]
    num = nb * BM

    def T(a, dt=dtype):
        return torch.as_tensor(a).to(device=device, dtype=dt).contiguous()

    own, take = T(s["own"], torch.int32), T(s["take"], torch.int32)
    runs = T(row_runs(s["own"], BM), torch.int32)  # static, as the solver's
    w, B, phi, dmat = T(s["w"]), T(s["B"]), T(s["phi"]), T(s["dmat"])
    rows = ops.gather_blocked_rows(B, take)
    rows_p, own_p, w_p = ops.pack_stream(B, take, own, w)
    groups = [g for g in GROUPS if nb % g == 0]
    variants = {
        "b1": lambda: ops.pos_hv_blocked(phi, rows, own, w, dmat, num, BM,
                                         W_SCALE, runs=runs),
        "packed": lambda: ops.pos_hv_packed(phi, rows_p, own_p, w_p, dmat,
                                            num, BM, W_SCALE, runs=runs),
    }
    for g in groups:
        variants[f"g{g}"] = (lambda g=g: ops.pos_hv_blocked_g(
            phi, rows, own, w, dmat, num, BM, g, W_SCALE, runs=runs))
    ref = ops.pos_hv_blocked_plain(phi, rows, own, w, dmat, num, BM, W_SCALE)
    res = {}
    for name, fn in variants.items():
        got = fn()
        res[f"{name}_max_rel"] = _max_rel(got, ref)
        res[f"{name}_bit_equal"] = bool(torch.equal(got, ref))
    if timed:
        for name, fn in variants.items():
            res[f"{name}_ms"] = _time_ms(fn)
        res["b1_plain_ms"] = _time_ms(lambda: ops.pos_hv_blocked_plain(
            phi, rows, own, w, dmat, num, BM, W_SCALE))
        # the per-solve relayouts: B1's and B10's row gather, B9's packing
        res["gather_ms"] = _time_ms(lambda: ops.gather_blocked_rows(B, take))
        res["pack_ms"] = _time_ms(lambda: ops.pack_stream(B, take, own, w))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m one_class_ffm_torch.hv_pack_bench",
        description="B1 against its lane-packed (B9) and G-batched (B10) "
                    "variants on one synthetic stream")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a GPU): check and "
                        "time the kernels; cpu: check the plain versions")
    args = p.parse_args(argv)
    if args.platform == "cpu":
        res = run(torch.device("cpu"), torch.float32, CPU_SHAPE, timed=False)
        for key, val in res.items():
            print(f"{key} {val}")
        ok = all(val for key, val in res.items() if key.endswith("bit_equal"))
        print("CPU correctness pass done (no timing)")
        return 0 if ok else 1
    if not torch.cuda.is_available():
        p.error("--platform cuda: no CUDA device is available")
    device = torch.device("cuda", 0)
    out = dict(device=torch.cuda.get_device_name(0), shape=dict(
        CARD_SHAPE, block_rows=BM, k=K, w_scale=W_SCALE))
    ok = True
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        out[name] = run(device, dt, CARD_SHAPE, timed=True)
        ok = ok and all(val for key, val in out[name].items()
                        if key.endswith("bit_equal"))
    out["launches"] = {name: kernels.launch_counts()[name]
                       for name in ("pos_hv_blocked", "pos_hv_packed",
                                    "pos_hv_blocked_g")}
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
