"""Run one cell of the benchmark of ``one_class_ffm_torch`` on the card.

    python3 ocffm_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with a trace
``breakdown``, and last ``checks``, each number compared with the
reference beside its limit; the same numbers end standard error.  Exits
non-zero, printing no result, without a CUDA device, and when the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ocffm_bench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("ocffm_bench: no CUDA device: nothing measured",
              file=sys.stderr)
        return 2
    bench, cell, ctx = harness.make_context(
        args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", T_START)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"ocffm_bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    res = harness.run_driver(ctx)
    line = harness.result_line(bench, ctx, res)
    bad = harness.forbidden_modules()
    if bad:
        print(f"ocffm_bench: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    for text in harness.check_lines(res):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
