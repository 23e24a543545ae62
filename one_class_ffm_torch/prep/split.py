"""Seeded line-level splits (reference kdd12.tools/split.py and
outbrain.tools/sample.py, same digit semantics and seed)."""

from __future__ import annotations

import os
import random
from typing import Tuple


def _name(path: str, tag: str) -> str:
    stem, ext = os.path.splitext(path)
    return f"{stem}.{tag}{ext}"


def split_file(path: str, seed: int = 0) -> Tuple[str, str, str]:
    """80/10/10 split: digit 0 -> te, 1 -> va, else tr (split.py:21-31).
    Also writes the ``.trva.`` concatenation (tr+va rows, used by the
    reference's .te sweep protocol: train on tr+va, evaluate on te,
    grid.sh:32-43).  Returns (tr_path, va_path, te_path)."""
    rd = random.Random()
    rd.seed(seed)
    tr_p, va_p, te_p = _name(path, "tr"), _name(path, "va"), _name(path, "te")
    trva_p = _name(path, "trva")
    with open(path) as f, open(tr_p, "w") as tr, open(va_p, "w") as va, open(
        te_p, "w"
    ) as te, open(trva_p, "w") as trva:
        for line in f:
            num = rd.randint(0, 9)
            if num == 0:
                te.write(line)
            elif num == 1:
                va.write(line)
                trva.write(line)
            else:
                tr.write(line)
                trva.write(line)
    return tr_p, va_p, te_p


def subsample(path: str, seed: int = 0) -> str:
    """20% subsample (digits 0-1) for faster eval (sample.py:18-25)."""
    rd = random.Random()
    rd.seed(seed)
    out_p = _name(path, "sub")
    with open(path) as f, open(out_p, "w") as out:
        for line in f:
            if rd.randint(0, 9) <= 1:
                out.write(line)
    return out_p
