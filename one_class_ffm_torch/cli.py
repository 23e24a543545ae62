"""Command line of the PyTorch port: the reference trainer's flags.

    python -m one_class_ffm_torch items.ffm train.ffm -p va.ffm --ns -k 8

The parser is the JAX package's ``build_parser`` with ``--platform`` taking
``cuda`` (the default) or ``cpu``.  A missing GPU under ``cuda`` is an
error.  Flags and models the port does not run yet fail with a message
naming them and the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from one_class_ffm_tpu.cli import build_parser as _reference_parser
from one_class_ffm_tpu.cli import config_from_args

from .train import NonFiniteMetricError, Trainer

PROG = "ocffm-torch"


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.prog = PROG
    p.description = "One-class FFM trainer (PyTorch/CUDA port)"
    for action in p._actions:
        if action.dest == "platform":
            action.choices = ["cuda", "cpu"]
            action.default = "cuda"
            action.help = ("device to train on: cuda (default; an error "
                           "when no GPU is available) or cpu")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.platform == "cuda" and not torch.cuda.is_available():
        parser.error("--platform cuda: no CUDA device is available "
                     "(pass --platform cpu to train on the CPU)")
    if args.threads:
        torch.set_num_threads(args.threads)
    cfg = config_from_args(args)
    if args.config:
        with open(args.config) as fh:
            overrides = json.load(fh)
        valid = {f.name for f in dataclasses.fields(cfg)}
        unknown = set(overrides) - valid
        if unknown:
            print(f"{PROG}: error: unknown config keys: {sorted(unknown)}",
                  file=sys.stderr)
            return 1
        # the file fills fields the command line left at their defaults
        defaults = config_from_args(
            parser.parse_args([args.item_file, args.train_file]))
        cfg = type(cfg)(**{
            f.name: (overrides[f.name]
                     if f.name in overrides
                     and getattr(cfg, f.name) == getattr(defaults, f.name)
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)})
    if cfg.k < 1:
        parser.error(f"-k must be >= 1 (got {cfg.k})")
    if cfg.nr_pass < 0:
        parser.error(f"-t must be >= 0 (got {cfg.nr_pass})")
    paths = [(cfg.item_path, "item file"), (cfg.train_path, "train file")]
    if cfg.test_path:
        paths.append((cfg.test_path, "test file"))
    for path, what in paths:
        if not os.path.exists(path):
            print(f"{PROG}: error: {what} not found: {path}", file=sys.stderr)
            return 1
    try:
        trainer = Trainer(cfg, device=args.platform)
    except NotImplementedError as e:
        print(f"{PROG}: error: not supported by the PyTorch port: {e}",
              file=sys.stderr)
        return 1
    if args.verbose:
        trainer.describe()
    try:
        trainer.run()
    except NonFiniteMetricError as e:
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 2
    if args.predict_topk and trainer.evaluator is not None:
        for row in trainer.predict_topk(k=args.predict_topk):
            print(",".join(str(int(x)) for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
