"""Sweep-log analysis (the logs.tools replacement), for the PyTorch port.

A copy of ``one_class_ffm_tpu/logtools.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_copies.py`` holds the two equal.  It
parses both row formats of the reference's logs (the old P@K-only rows and
the ``( p , ndcg )`` rows the port prints) and reports, per variant
directory, the best configuration for each metric.

CLI:
    python -m one_class_ffm_torch.logtools best <logdir>     # best per metric
    python -m one_class_ffm_torch.logtools show <logfile>    # parsed rows
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

TOP_KS = (5, 10, 20, 40, 80)

# "t ( p , ndcg ) x5 ploss"  (print_epoch_info format, ffm.cpp:1130-1145)
_PAIR = re.compile(r"\(\s*([\d.eE+-]+)\s*,\s*([\d.eE+-]+)\s*\)")


@dataclass
class Row:
    epoch: int
    p: Dict[int, float]
    ndcg: Dict[int, float]
    ploss: Optional[float]


def parse_row(line: str) -> Optional[Row]:
    toks = line.split()
    if not toks or not toks[0].isdigit():
        return None
    epoch = int(toks[0])
    pairs = _PAIR.findall(line)
    p: Dict[int, float] = {}
    nd: Dict[int, float] = {}
    ploss = None
    if pairs:
        for K, (pv, nv) in zip(TOP_KS, pairs):
            p[K] = float(pv)
            nd[K] = float(nv)
        tail = line.rsplit(")", 1)[-1].split()
        if tail:
            try:
                ploss = float(tail[-1])
            except ValueError:
                ploss = None
    else:
        # old format: "t p@5 p@10 p@20 p@40 [p@80] [ploss]"
        vals = [float(x) for x in toks[1:]]
        for K, v in zip(TOP_KS, vals):
            p[K] = v
        if len(vals) > len(TOP_KS):
            ploss = vals[-1]
    return Row(epoch=epoch, p=p, ndcg=nd, ploss=ploss)


def parse_log(path: str) -> List[Row]:
    rows = []
    with open(path) as fh:
        for ln in fh:
            r = parse_row(ln.strip())
            if r is not None:
                rows.append(r)
    return rows


def final_row(path: str) -> Optional[Row]:
    rows = parse_log(path)
    return rows[-1] if rows else None


def best_in_dir(d: str) -> Dict[str, tuple]:
    """Best final-epoch value per metric across every log file in ``d``.
    Returns {metric: (value, filename, epoch)}."""
    best: Dict[str, tuple] = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            continue
        r = final_row(path)
        if r is None:
            continue
        for K in TOP_KS:
            if K in r.p:
                key = f"p@{K}"
                if key not in best or r.p[K] > best[key][0]:
                    best[key] = (r.p[K], name, r.epoch)
            if K in r.ndcg:
                key = f"ndcg@{K}"
                if key not in best or r.ndcg[K] > best[key][0]:
                    best[key] = (r.ndcg[K], name, r.epoch)
        if r.ploss is not None:
            if "ploss" not in best or r.ploss < best["ploss"][0]:
                best["ploss"] = (r.ploss, name, r.epoch)
    return best


def cmd_best(logdir: str, echo=print) -> int:
    for sub in sorted(os.listdir(logdir)):
        d = os.path.join(logdir, sub)
        if not os.path.isdir(d):
            continue
        echo("-" * 72)
        echo(d)
        for metric, (val, name, epoch) in sorted(best_in_dir(d).items()):
            echo(f"  {metric:>8}: {val:<10g} @epoch {epoch:<4} {name}")
    return 0


def cmd_show(path: str, echo=print) -> int:
    for r in parse_log(path):
        parts = [f"{r.epoch:>3}"]
        for K in TOP_KS:
            if K in r.p:
                nd = r.ndcg.get(K)
                parts.append(
                    f"p@{K}={r.p[K]:g}" + (f" ndcg@{K}={nd:g}" if nd is not None else "")
                )
        if r.ploss is not None:
            parts.append(f"ploss={r.ploss:g}")
        echo("  ".join(parts))
    return 0


def cmd_sync(logdir: str, branch: str, remote: str, echo=print) -> int:
    """Commit and push the sweep-log directory to a tracking branch.

    Replaces the reference's log-sync flow (script/logs.tools/sync-log.sh:1-6:
    ``git add logs/ && commit && pull/push origin track_logs``) with the same
    steps made safe to re-run: a clean tree commits nothing, and pull/push
    failures (no remote configured, offline) are reported but non-fatal so a
    local commit still lands.
    """
    import subprocess

    repo = os.path.dirname(os.path.abspath(logdir)) or "."

    def git(*argv, fatal=True):
        r = subprocess.run(["git", "-C", repo, *argv], capture_output=True,
                           text=True)
        if r.stdout.strip():
            echo(r.stdout.strip())
        if r.returncode != 0:
            echo(r.stderr.strip())
            if fatal:
                raise SystemExit(r.returncode)
        return r.returncode

    git("add", os.path.basename(os.path.abspath(logdir)))
    staged = git("diff", "--cached", "--quiet", fatal=False)
    if staged == 0:
        echo("sync: nothing to commit")
    else:
        git("commit", "-m", "Update log")
    if git("pull", remote, branch, fatal=False) != 0:
        echo(f"sync: pull {remote} {branch} failed (no remote?); kept local")
        return 0
    if git("push", remote, branch, fatal=False) != 0:
        echo(f"sync: push {remote} {branch} failed; kept local")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-logtools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("best", help="best config per metric, per variant dir")
    b.add_argument("logdir")
    s = sub.add_parser("show", help="parsed rows of one log")
    s.add_argument("logfile")
    y = sub.add_parser("sync", help="commit+push a log dir to a track branch")
    y.add_argument("logdir")
    y.add_argument("--branch", default="track_logs")
    y.add_argument("--remote", default="origin")
    args = ap.parse_args(argv)
    if args.cmd == "best":
        return cmd_best(args.logdir)
    if args.cmd == "sync":
        return cmd_sync(args.logdir, args.branch, args.remote)
    return cmd_show(args.logfile)


if __name__ == "__main__":
    sys.exit(main())
