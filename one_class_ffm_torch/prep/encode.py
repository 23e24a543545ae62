"""Generic field encoder for the one-class FFM text formats.

The reference ships twelve near-identical encoder scripts (six per dataset:
{user,ad|context,item} x {ffm,fm,mf} — reference script/kdd12.tools/*_*.py,
script/outbrain.tools/*_*.py).  They all do the same thing: walk CSV rows,
assign each distinct ``column:value`` a contiguous per-field feature id, and
emit ``label 0:idx:1 1:idx:1 ...`` rows.  This module is that pattern once,
parameterized by a field layout, with support for multi-valued cells
(``|``-separated) and per-column special handlers (Outbrain geo parsing).
"""

from __future__ import annotations

import csv
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


class FeatureSpace:
    """Per-field contiguous id assignment for ``column:value`` keys."""

    def __init__(self, n_fields: int):
        self.maps: List[Dict[str, int]] = [dict() for _ in range(n_fields)]

    def add(self, field: int, col: str, value: str) -> int:
        key = f"{col}:{value}"
        m = self.maps[field]
        if key not in m:
            m[key] = len(m)
        return m[key]

    def dims(self) -> List[int]:
        return [len(m) for m in self.maps]


# special handler signature: (space, field, value) -> list of feature ids
SpecialHandler = Callable[[FeatureSpace, int, str], List[int]]


def geo_handler(space: FeatureSpace, field: int, value: str) -> List[int]:
    """Outbrain geo_location parsing (context_ffm.py handle_geo):
    'country>state>code' with 1-3 components; a trailing all-digit component
    is a code, otherwise a state."""
    items = value.split(">")
    if len(items) == 1:
        kind = "code" if items[0].isdigit() else "country"
        return [space.add(field, kind, items[0])]
    if len(items) == 2:
        second = "code" if items[1].isdigit() else "state"
        return [
            space.add(field, "country", items[0]),
            space.add(field, second, items[1]),
        ]
    return [
        space.add(field, "country", items[0]),
        space.add(field, "state", items[1]),
        space.add(field, "code", items[2]),
    ]


def encode_rows(
    rows: Iterable[Dict[str, str]],
    fields: Sequence[Sequence[str]],
    out_path: str,
    label_col: Optional[str] = None,
    space: Optional[FeatureSpace] = None,
    special: Optional[Dict[str, SpecialHandler]] = None,
    multi_sep: str = "|",
) -> FeatureSpace:
    """Encode dict-rows into the text format.

    ``fields``: per output field, the list of source columns.
    ``label_col``: column holding '|'-separated positive ids (ffm/fm/mf user
    side); None for item files.
    ``space``: pass an existing FeatureSpace to share ids across files
    (e.g. train/va/te encoded in one pass, as the reference does).
    """
    special = special or {}
    if space is None:
        space = FeatureSpace(len(fields))
    with open(out_path, "w") as out:
        for row in rows:
            parts: List[str] = []
            if label_col is not None:
                parts.append(row[label_col].strip().replace(multi_sep, ","))
            for fi, cols in enumerate(fields):
                ids: List[int] = []
                for col in cols:
                    raw = (row.get(col) or "").strip()
                    if raw == "":
                        continue
                    if col in special:
                        ids.extend(special[col](space, fi, raw))
                        continue
                    for val in raw.split(multi_sep):
                        ids.append(space.add(fi, col, val.strip()))
                parts.extend(f"{fi}:{i}:1" for i in ids)
            out.write(" ".join(parts) + "\n")
    return space


def encode_csv(
    csv_path: str,
    fields: Sequence[Sequence[str]],
    out_path: str,
    label_col: Optional[str] = None,
    space: Optional[FeatureSpace] = None,
    special: Optional[Dict[str, SpecialHandler]] = None,
) -> FeatureSpace:
    with open(csv_path, newline="") as fh:
        return encode_rows(
            csv.DictReader(fh), fields, out_path, label_col, space, special
        )


def merge_fields(fields: Sequence[Sequence[str]]) -> List[List[str]]:
    """FFM layout -> FM layout: all columns in one field."""
    return [[c for f in fields for c in f]]
