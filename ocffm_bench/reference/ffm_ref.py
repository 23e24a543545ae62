"""Plain PyTorch reference of one-class FFM / FM / MF training.

Written from the loss, independently of the program under test:

    L = 1/2 [ sum_{(i,j) in POS} (yhat_ij - 1)^2
            + omega * sum_{(i,j) not in POS} (yhat_ij - r)^2
            + lam * sum_blocks (||W||^2 + ||H||^2) ]
    yhat_ij = a_i + b_j + sum_{cross blocks} <P_i, Q_j>

with P = X_f1 W and Q = X_f2 H per block, a_i (b_j) the sums of the user
(item) self blocks' <P_i, Q_i>.  One epoch visits the user self blocks,
the item self blocks, then the cross blocks; in each block it solves for
W, then for H, by one Gauss-Newton step: the gradient G, then conjugate
gradients on H S = -G from S = 0, stopped when ||r||^2 <= eps ||G||^2 or
after ``cg_max_iter`` iterations, and T += S.  The sums over all
user-item pairs are taken in rank-k form (k x k Grams); the sums over the
positives by gathers and ``index_add_``.  Every cache (projections, side
sums, scores at the positives) is computed anew from the tables before
each half-solve.

Inputs are the plain arrays the benchmark makes (``gen.Problem``) and the
initial tables; nothing of the program is read.  ``dtype`` float64 is the
reference.  The control is float32 with ``tf32``: every operand of a
product that a contraction sums (a matmul, a projection X T, a scatter
X^T Z, a dot product at the positives, the Hv's products) is first
rounded to TF32's 10-bit mantissa, as a tensor core rounds it, and the
products are summed in float32; the CG recurrence stays in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def round_tf32(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to nearest (ties to even) on TF32's 10-bit
    mantissa: the value that a tensor core multiplies."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _same(x: Tensor) -> Tensor:
    return x


def block_id(f1: int, f2: int, f: int) -> int:
    """Flat id of the field pair (f1, f2), f1 <= f2: the position of the
    block in the list of all f (f + 1) / 2 pairs taken row by row."""
    return f2 + (f - 1) * f1 - f1 * (f1 - 1) // 2


@dataclass(frozen=True)
class Block:
    f12: int
    kind: str  # "uu", "vv" or "uv"
    fi: int  # the first field, as an index on its side
    fj: int  # the second field, as an index on its side


def blocks(fu: int, fv: int, self_side: bool) -> List[Block]:
    """Every block in epoch order: user self, item self, then cross."""
    f = fu + fv
    uu = [Block(block_id(a, b, f), "uu", a, b)
          for a in range(fu) for b in range(a, fu)]
    vv = [Block(block_id(fu + a, fu + b, f), "vv", a, b)
          for a in range(fv) for b in range(a, fv)]
    uv = [Block(block_id(a, fu + b, f), "uv", a, b)
          for a in range(fu) for b in range(fv)]
    return (uu + vv + uv) if self_side else uv


class Field:
    """X of one field: padded (rows, p) ids and values, or the identity."""

    def __init__(self, idx: np.ndarray, val: np.ndarray, ident: bool,
                 dim: int, device, dtype, rnd=_same):
        self.rnd = rnd
        self.ident = ident
        self.dim = dim
        self.rows = idx.shape[0]
        self.idx = torch.as_tensor(idx, device=device).long()
        self.val = torch.as_tensor(val, device=device).to(dtype)

    def project(self, T: Tensor) -> Tensor:
        """X T, (rows, k)."""
        if self.ident:
            return T[: self.rows]
        return (self.rnd(T)[self.idx] * self.rnd(self.val)[..., None]
                ).sum(dim=1)

    def scatter(self, Z: Tensor) -> Tensor:
        """X^T Z, (dim, k)."""
        if self.ident:
            out = torch.zeros((self.dim, Z.shape[1]), dtype=Z.dtype,
                              device=Z.device)
            out[: self.rows] = Z
            return out
        out = torch.zeros((self.dim, Z.shape[1]), dtype=Z.dtype,
                          device=Z.device)
        contrib = (self.rnd(self.val)[..., None] * self.rnd(Z)[:, None, :]
                   ).reshape(-1, Z.shape[1])
        out.index_add_(0, self.idx.reshape(-1), contrib)
        return out


class Reference:
    """The problem on ``device`` at ``dtype``; tables are dicts {f12:
    {"W": (d1, k), "H": (d2, k)}} at this dtype."""

    def __init__(self, problem, hyper: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 operands")
        self.dtype = dtype
        self.rnd = round_tf32 if tf32 else _same
        self.device = torch.device(device)
        self.k = int(hyper["k"])
        self.lam = float(hyper["lam"])
        self.omega = float(hyper["omega"])
        self.r = float(hyper["r"])
        self.eps = float(hyper["cg_eps"])
        self.cap = int(hyper["cg_max_iter"])

        def fields(side):
            return [Field(i, v, s, d, device, dtype, self.rnd)
                    for i, v, s, d in
                    zip(side.idx, side.val, side.ident, side.dims)]

        self.Xu, self.Xv = fields(problem.users), fields(problem.items)
        self.m, self.n = problem.users.rows, problem.items.rows
        self.pu = torch.as_tensor(problem.pos_u, device=device).long()
        self.pv = torch.as_tensor(problem.pos_v, device=device).long()
        self.cnt_u = torch.bincount(self.pu, minlength=self.m).to(dtype)
        self.cnt_v = torch.bincount(self.pv, minlength=self.n).to(dtype)
        self.blocks = blocks(len(self.Xu), len(self.Xv),
                             bool(hyper["self_side"]))
        self.cross = [b for b in self.blocks if b.kind == "uv"]
        # the norm of each leaf's first gradient, (f12, "W"/"H") -> float
        self.first_grad: Dict[Tuple[int, str], float] = {}
        # CG iterations per half-solve of each epoch run by ``compare``
        self.iters: List[List[int]] = []

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.rnd(a) @ self.rnd(b)

    def mul(self, a: Tensor, b: Tensor) -> Tensor:
        """An elementwise product whose terms a contraction sums."""
        return self.rnd(a) * self.rnd(b)

    # -- fields of a block ----------------------------------------------------

    def _fields(self, b: Block) -> Tuple[Field, Field]:
        if b.kind == "uu":
            return self.Xu[b.fi], self.Xu[b.fj]
        if b.kind == "vv":
            return self.Xv[b.fi], self.Xv[b.fj]
        return self.Xu[b.fi], self.Xv[b.fj]

    def caches(self, tables):
        """P, Q per block, the side sums a, b and yhat at the positives."""
        P, Q = {}, {}
        for b in self.blocks:
            X1, X2 = self._fields(b)
            P[b.f12] = X1.project(tables[b.f12]["W"])
            Q[b.f12] = X2.project(tables[b.f12]["H"])
        a = torch.zeros(self.m, dtype=self.dtype, device=self.device)
        bv = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        for b in self.blocks:
            if b.kind == "uu":
                a = a + self.mul(P[b.f12], Q[b.f12]).sum(dim=1)
            elif b.kind == "vv":
                bv = bv + self.mul(P[b.f12], Q[b.f12]).sum(dim=1)
        yhat = a[self.pu] + bv[self.pv]
        for b in self.cross:
            yhat = yhat + self.mul(P[b.f12][self.pu],
                                   Q[b.f12][self.pv]).sum(dim=1)
        return P, Q, a, bv, yhat

    # -- one half-solve -------------------------------------------------------

    def grad_hv(self, tables, b: Block, first: bool):
        """G and the Hv closure for the W (``first``) or H table of ``b``."""
        w, r, lam = self.omega, self.r, self.lam
        P, Q, a, bv, yhat = self.caches(tables)
        T = tables[b.f12]["W" if first else "H"]
        X1, X2 = self._fields(b)
        if not first:
            X1, X2 = X2, X1
        coef = (1.0 - w) * (yhat - 1.0) - w * (1.0 - r)
        if b.kind == "uv":
            if first:
                B, own_c, oth_c, side, oth = Q[b.f12], P, Q, a, bv
                own_ids, oth_ids = self.pu, self.pv
            else:
                B, own_c, oth_c, side, oth = P[b.f12], Q, P, bv, a
                own_ids, oth_ids = self.pv, self.pu
            dense = (side - r)[:, None] * self.rnd(B).sum(dim=0)[None, :] \
                + self.mm(B.T, oth[:, None])[:, 0][None, :]
            for c in self.cross:
                dense = dense + self.mm(own_c[c.f12],
                                        self.mm(oth_c[c.f12].T, B))
            Bg = B[oth_ids]
            rows = w * dense
            rows.index_add_(0, own_ids, self.mul(coef[:, None], Bg))
            G = lam * T + X1.scatter(rows)
            gram = self.mm(B.T, B)

            def hv(V: Tensor) -> Tensor:
                phi = X1.project(V)
                t = w * self.mm(phi, gram)
                s = (1.0 - w) * self.mul(phi[own_ids], Bg).sum(dim=1)
                t.index_add_(0, own_ids, self.mul(s[:, None], Bg))
                return lam * V + X1.scatter(t)

            return G, hv
        B = Q[b.f12] if first else P[b.f12]
        if b.kind == "uu":
            n_oth, side, oth, ids, cnt = self.n, a, bv, self.pu, self.cnt_u
            s_cache = sum(self.mm(P[c.f12], self.rnd(Q[c.f12]).sum(dim=0))
                          for c in self.cross) \
                if self.cross else torch.zeros_like(a)
        else:
            n_oth, side, oth, ids, cnt = self.m, bv, a, self.pv, self.cnt_v
            s_cache = sum(self.mm(Q[c.f12], self.rnd(P[c.f12]).sum(dim=0))
                          for c in self.cross) \
                if self.cross else torch.zeros_like(bv)
        z = w * (n_oth * (side - r) + oth.sum() + s_cache)
        z = z.index_add(0, ids, coef)
        G = lam * T + X1.scatter(self.mul(z[:, None], B))
        d = (1.0 - w) * cnt + w * n_oth

        def hv(V: Tensor) -> Tensor:
            s = d * self.mul(B, X1.project(V)).sum(dim=1)
            return lam * V + X1.scatter(self.mul(s[:, None], B))

        return G, hv

    def cg(self, hv, G: Tensor) -> Tuple[Tensor, int]:
        S = torch.zeros_like(G)
        R = -G
        V = R.clone()
        g2 = float((G * G).sum())
        r2 = rz = g2
        it = 0
        while r2 > self.eps * g2 and it < self.cap:
            it += 1
            Hv = hv(V)
            den = float((V * Hv).sum())
            if not den > 0:
                break
            alpha = rz / den
            S = S + alpha * V
            R = R - alpha * Hv
            r2 = float((R * R).sum())
            V = R + (r2 / rz) * V
            rz = r2
        return S, it

    def epoch(self, tables):
        """One sweep; returns (new tables, CG iterations per half-solve)."""
        tables = {f: dict(t) for f, t in tables.items()}
        iters = []
        for b in self.blocks:
            for first, key in ((True, "W"), (False, "H")):
                G, hv = self.grad_hv(tables, b, first)
                self.first_grad.setdefault(
                    (b.f12, key), float(torch.linalg.vector_norm(G)))
                S, it = self.cg(hv, G)
                tables[b.f12][key] = tables[b.f12][key] + S
                iters.append(it)
        return tables, iters

    # -- the loss ---------------------------------------------------------------

    def objective(self, tables) -> float:
        """L of the tables, in rank-k form over all pairs."""
        w, r = self.omega, self.r
        P, Q, a, bv, yhat = self.caches(tables)
        al, be = a - r, bv
        e2 = self.n * (al * al).sum() + self.m * (be * be).sum() \
            + 2.0 * al.sum() * be.sum()
        for c in self.cross:
            e2 = e2 + 2.0 * (al @ (P[c.f12] @ Q[c.f12].sum(dim=0)))
            e2 = e2 + 2.0 * (be @ (Q[c.f12] @ P[c.f12].sum(dim=0)))
            for c2 in self.cross:
                e2 = e2 + ((P[c.f12].T @ P[c2.f12])
                           * (Q[c.f12].T @ Q[c2.f12])).sum()
        loss = ((yhat - 1.0) ** 2).sum() \
            + w * (e2 - ((yhat - r) ** 2).sum())
        for t in tables.values():
            loss = loss + self.lam * ((t["W"] ** 2).sum() + (t["H"] ** 2).sum())
        return 0.5 * float(loss)

    def cast(self, tables):
        """Tables at this reference's dtype and device."""
        return {f: {n: t.to(self.device, self.dtype) for n, t in blk.items()}
                for f, blk in tables.items()}


def init_tables(dims: Dict[int, Tuple[int, int]], k: int, seed: int,
                device) -> Dict[int, Dict[str, Tensor]]:
    """The initial tables, float32, U(-0.1/sqrt(k), 0.1/sqrt(k)) (the
    reference's init law), drawn on ``device`` from ``seed`` in one call
    and cut into the blocks in ``dims`` order ({f12: (d1, d2)})."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    rows = sum(d1 + d2 for d1, d2 in dims.values())
    flat = torch.rand((rows, k), generator=gen, device=device,
                      dtype=torch.float32)
    flat = (2.0 * flat - 1.0) * (0.1 / math.sqrt(k))
    out, lo = {}, 0
    for f12, (d1, d2) in dims.items():
        out[f12] = dict(W=flat[lo:lo + d1], H=flat[lo + d1:lo + d1 + d2])
        lo += d1 + d2
    return out


def start_tables(problem, self_side: bool, k: int, seed: int, device
                 ) -> Dict[int, Dict[str, Tensor]]:
    """``init_tables`` of the problem's blocks, drawn from ``seed`` for
    its rows as drawn, then each id field's rows moved to where the
    problem's relabeling moved the rows (``problem.user_label``,
    ``item_label``: row i to row label[i]); other fields' rows stay."""
    users, items = problem.users, problem.items
    dims = table_dims(users.dims, items.dims, self_side)
    tables = init_tables(dims, k, seed, device)
    moves = {}
    for side, label in ((users, problem.user_label),
                        (items, problem.item_label)):
        inv = torch.as_tensor(np.argsort(label), device=device)
        moves[id(side)] = [inv if ident else None for ident in side.ident]
    out = {}
    for b in blocks(len(users.dims), len(items.dims), self_side):
        s1 = users if b.kind in ("uu", "uv") else items
        s2 = users if b.kind == "uu" else items
        m1, m2 = moves[id(s1)][b.fi], moves[id(s2)][b.fj]
        W, H = tables[b.f12]["W"], tables[b.f12]["H"]
        # copies, so that the one draw is freed
        out[b.f12] = dict(W=W.clone() if m1 is None else W[m1],
                          H=H.clone() if m2 is None else H[m2])
    return out


def table_dims(fu_dims: List[int], fv_dims: List[int],
               self_side: bool) -> Dict[int, Tuple[int, int]]:
    """{f12: (rows of W, rows of H)} of every block, in epoch order."""
    dims = list(fu_dims) + list(fv_dims)
    fu = len(fu_dims)
    out = {}
    for b in blocks(fu, len(fv_dims), self_side):
        g1 = b.fi if b.kind in ("uu", "uv") else fu + b.fi
        g2 = b.fj if b.kind == "uu" else fu + b.fj
        out[b.f12] = (dims[g1], dims[g2])
    return out
