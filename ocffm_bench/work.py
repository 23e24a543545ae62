"""The work the algorithm requires, counted from shapes, and its least time
on the card.

Each pass is counted as its floating-point operations and the bytes of its
inputs read once and its outputs written once (float32 values and int32
ids, 4 bytes each; a non-identity field's X as one id and one value per
nonzero; an identity field's X costs nothing).  The algorithm is the
reference's: per half-solve a gradient, a CG start, per CG iteration one
Hv and one recurrence, and a step that moves the table, its cache and the
residual carried at the positives.  A pass's least time is the larger of
its operations at the peak rate and its bytes at the peak bandwidth
(``peaks.json``).  Nothing here depends on how the program implements a
pass, so a new kernel leaves the count as it is.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .reference.ffm_ref import blocks

F = 4  # bytes of a float32 value or an int32 id


@dataclass(frozen=True)
class FieldShape:
    dim: int
    nnz_per_row: int
    ident: bool


@dataclass(frozen=True)
class Shape:
    m: int  # users
    n: int  # items
    nnz: int  # training positives
    k: int
    u: Tuple[FieldShape, ...]
    v: Tuple[FieldShape, ...]
    self_side: bool


def shape_of(cfg: dict, nnz: int) -> Shape:
    def side(name, rows):
        return tuple(FieldShape(rows if f["kind"] == "id" else
                                int(sum(f["groups"])),
                                1 if f["kind"] == "id" else len(f["groups"]),
                                f["kind"] == "id")
                     for f in cfg[name + "_fields"])
    return Shape(int(cfg["users"]), int(cfg["items"]), int(nnz), int(cfg["k"]),
                 side("user", int(cfg["users"])),
                 side("item", int(cfg["items"])), bool(cfg["self_side"]))


def load_peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the card named ``kind`` (``peaks.json``);
    KeyError for a card the table does not hold."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as fh:
        return json.load(fh)[kind]


class Counter:
    """Sums passes as (flops, bytes) and their least times."""

    def __init__(self, peaks: Dict[str, float]):
        self.flops_s = float(peaks["f32_flops_per_s"])
        self.bytes_s = float(peaks["bytes_per_s"])
        self.flops = 0.0
        self.bytes = 0.0
        self.seconds = 0.0

    def add(self, flops: float, nbytes: float, times: float = 1.0) -> None:
        self.flops += flops * times
        self.bytes += nbytes * times
        self.seconds += max(flops / self.flops_s, nbytes / self.bytes_s) \
            * times


def _x_bytes(f: FieldShape, rows: int) -> int:
    return 0 if f.ident else 2 * F * rows * f.nnz_per_row


def _x_nnz(f: FieldShape, rows: int) -> int:
    return 0 if f.ident else rows * f.nnz_per_row


def half_solves(s: Shape) -> List[Tuple[str, FieldShape, int, int]]:
    """(kind, own field, own rows, other rows) of each half-solve, in
    epoch order (a block's W then its H)."""
    out = []
    for b in blocks(len(s.u), len(s.v), s.self_side):
        if b.kind == "uu":
            out += [("uu", s.u[b.fi], s.m, s.n), ("uu", s.u[b.fj], s.m, s.n)]
        elif b.kind == "vv":
            out += [("vv", s.v[b.fi], s.n, s.m), ("vv", s.v[b.fj], s.n, s.m)]
        else:
            out += [("uv", s.u[b.fi], s.m, s.n), ("uv", s.v[b.fj], s.n, s.m)]
    return out


def epoch_work(s: Shape, cg_iters: Sequence[int], c: Counter) -> None:
    """Add one epoch: ``cg_iters`` per half-solve in epoch order."""
    k, nnz = s.k, s.nnz
    n_cross = len(s.u) * len(s.v)
    solves = half_solves(s)
    if len(cg_iters) != len(solves):
        raise ValueError(f"{len(cg_iters)} CG counts for {len(solves)} "
                         "half-solves")
    if s.self_side:
        # the self gradients' sums over the other side: every cross cache
        c.add(2.0 * n_cross * k * (s.m + s.n),
              F * n_cross * k * (s.m + s.n) + F * (s.m + s.n))
    for (kind, f, n1, n2), iters in zip(solves, cg_iters):
        d1, nx = f.dim, _x_nnz(f, n1)
        xb = _x_bytes(f, n1)
        tbl = F * d1 * k
        if kind == "uv":
            # gradient: the positives' part, the k x k Grams, X^T
            c.add(2.0 * nnz * k + 2.0 * k * k * n_cross * (n1 + n2)
                  + 2.0 * nx * k,
                  2 * tbl + F * k * (n_cross * n1 + n_cross * n2)
                  + F * (n1 + n2) + 3 * F * nnz + xb)
            hv_flops = 4.0 * nnz * k + 2.0 * n1 * k * k + 4.0 * nx * k
            hv_bytes = 2 * tbl + F * n2 * k + 2 * F * nnz + xb
            # step: the table, its cache, the residual at the positives
            st_flops = d1 * k + 2.0 * nx * k + 2.0 * nnz * k
            st_bytes = 3 * tbl + 2 * F * n1 * k + F * n2 * k \
                + 4 * F * nnz + xb
        else:
            c.add(2.0 * nnz + 2.0 * n1 * k + 2.0 * nx * k,
                  2 * tbl + F * n1 * k + 2 * F * n1 + 2 * F * nnz + xb)
            hv_flops = 4.0 * n1 * k + 4.0 * nx * k
            hv_bytes = 2 * tbl + F * n1 * k + F * n1 + xb
            st_flops = d1 * k + 2.0 * nx * k + 2.0 * n1 * k
            st_bytes = 3 * tbl + 3 * F * n1 * k + 4 * F * nnz + xb
        c.add(2.0 * d1 * k, 4 * tbl)  # CG start: G in; S, R, V out
        c.add(hv_flops, hv_bytes, iters)
        c.add(10.0 * d1 * k, 7 * tbl, iters)  # recurrence: 4 in, 3 out
        c.add(st_flops, st_bytes)


def restore_work(s: Shape, c: Counter) -> None:
    """A job's start: every cache from the tables and the residual at the
    positives."""
    k = s.k
    n_cross = len(s.u) * len(s.v)
    bl = blocks(len(s.u), len(s.v), s.self_side)
    for b in bl:
        if b.kind == "uu":
            pairs = ((s.u[b.fi], s.m), (s.u[b.fj], s.m))
        elif b.kind == "vv":
            pairs = ((s.v[b.fi], s.n), (s.v[b.fj], s.n))
        else:
            pairs = ((s.u[b.fi], s.m), (s.v[b.fj], s.n))
        for f, rows in pairs:
            c.add(2.0 * _x_nnz(f, rows) * k,
                  F * f.dim * k + _x_bytes(f, rows) + F * rows * k)
    c.add(2.0 * s.nnz * k * n_cross,
          F * k * n_cross * (s.m + s.n) + 3 * F * s.nnz)


def rank_request_work(s: Shape, users: int, top_k: int,
                      c: Counter) -> None:
    """One request: its users' projections, the scores of every item
    (P Q^T per cross block), and the top ids; the item side (Q, b) is read
    once and the ids written once."""
    k = s.k
    n_cross = len(s.u) * len(s.v)
    proj_flops = sum(2.0 * users * (1 if f.ident else f.nnz_per_row) * k
                     * len(s.v) for f in s.u)
    proj_bytes = sum(F * users * (1 if f.ident else f.nnz_per_row) * k
                     * len(s.v) + _x_bytes(f, users) for f in s.u)
    c.add(proj_flops + 2.0 * users * s.n * k * n_cross
          + users * s.n * (n_cross + 1),
          proj_bytes + F * s.n * k * n_cross + F * s.n
          + 2 * F * users * top_k)
