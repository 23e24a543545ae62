"""Brute-force numpy oracle for the one-class FFM objective and solver.

A copy of ``one_class_ffm_tpu/solver/oracle.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

Everything here is O(m*n*k) dense float64 math derived directly from the loss

    L = 1/2 [ sum_{(i,j) in POS} (yhat_ij - 1)^2
            + omega * sum_{(i,j) not in POS} (yhat_ij - r)^2
            + sum_blocks lambda * ||.||^2_(freq) ]

    yhat_ij = a_i + b_j + sum_{cross blocks} <P_i, Q_j>

(the exact form the reference's debug ``func()`` brute-forces,
ffm.cpp:1321-1351).  It exists to *gate* the fast TPU path: the JAX solver
must match this oracle block-for-block on tiny data.

``oracle_epoch`` runs the same alternating Gauss-Newton sweep as the fast
path (same block order, same CG iteration, same stopping rule,
ffm.cpp:744-870) but with gradients/Hessian-vector products computed from the
dense residual matrix, so agreement is a strong end-to-end check of the
rank-k algebra (sa/sb caches, k x k Grams, incremental residuals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.blocks import BlockInfo, BlockLayout
from .params import HyperParams

Arr = np.ndarray


@dataclass
class OracleProblem:
    layout: BlockLayout
    hp: HyperParams
    Xu: List[Arr]  # per user field: dense (m, Du[fi]) float64
    Xv: List[Arr]  # per item field: dense (n, Dv[fi])
    pos: Arr  # (m, n) bool — positive pairs
    freq_u: Optional[List[Arr]] = None  # per field feature counts (for --freq)
    freq_v: Optional[List[Arr]] = None

    @property
    def m(self) -> int:
        return self.Xu[0].shape[0]

    @property
    def n(self) -> int:
        return self.Xv[0].shape[0]

    def side_X(self, b: BlockInfo, first: bool) -> Arr:
        """Dense feature matrix for the block's f1 (first=True) or f2 side."""
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        return self.Xu[fl] if fg < self.layout.fu else self.Xv[fl]

    def side_freq(self, b: BlockInfo, first: bool) -> Arr:
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        fr = self.freq_u if fg < self.layout.fu else self.freq_v
        assert fr is not None
        return fr[fl]


def projections(prob: OracleProblem, params: Dict[str, Dict[int, Arr]]):
    """P[f12] = X_{f1} W[f12], Q[f12] = X_{f2} H[f12] for active blocks."""
    P, Q = {}, {}
    for b in prob.layout.all_blocks():
        P[b.f12] = prob.side_X(b, True) @ params["W"][b.f12]
        Q[b.f12] = prob.side_X(b, False) @ params["H"][b.f12]
    return P, Q


def predict_dense(prob: OracleProblem, params) -> Arr:
    """Full (m, n) score matrix yhat = a_i + b_j + cross(i, j)."""
    P, Q = projections(prob, params)
    lay = prob.layout
    a = np.zeros(prob.m)
    b_vec = np.zeros(prob.n)
    yh = np.zeros((prob.m, prob.n))
    for b in lay.user_self_blocks():
        a += np.einsum("ik,ik->i", P[b.f12], Q[b.f12])
    for b in lay.item_self_blocks():
        b_vec += np.einsum("ik,ik->i", P[b.f12], Q[b.f12])
    for b in lay.cross_blocks():
        yh += P[b.f12] @ Q[b.f12].T
    return yh + a[:, None] + b_vec[None, :]


def _reg_weights(prob: OracleProblem, b: BlockInfo, first: bool) -> Arr:
    """Per-row lambda multiplier: freq counts under --freq, else ones."""
    d = b.d1 if first else b.d2
    if prob.hp.freq:
        return prob.side_freq(b, first).astype(np.float64)
    return np.ones(d)


def objective(prob: OracleProblem, params) -> float:
    """Exact loss (reference func(), ffm.cpp:1321-1351; freq-lambda variant
    regularizes each table row by lambda * freq[row])."""
    hp = prob.hp
    yh = predict_dense(prob, params)
    pos = prob.pos
    res = float(((1.0 - yh[pos]) ** 2).sum())
    res += hp.omega * float(((hp.r - yh[~pos]) ** 2).sum())
    for b in prob.layout.all_blocks():
        rw1 = _reg_weights(prob, b, True)
        rw2 = _reg_weights(prob, b, False)
        res += hp.lam * float((rw1[:, None] * params["W"][b.f12] ** 2).sum())
        res += hp.lam * float((rw2[:, None] * params["H"][b.f12] ** 2).sum())
    return 0.5 * res


def _C_matrix(prob: OracleProblem, yh: Arr) -> Arr:
    """dL/dyhat: (yhat - 1) on positives, omega*(yhat - r) elsewhere."""
    hp = prob.hp
    return np.where(prob.pos, yh - 1.0, hp.omega * (yh - hp.r))


def _W_matrix(prob: OracleProblem) -> Arr:
    """Per-pair quadratic weight: 1 on positives, omega elsewhere."""
    return np.where(prob.pos, 1.0, prob.hp.omega)


def _cg(grad_fn_hv, G: Arr, hp: HyperParams, D: Optional[Arr] = None) -> Arr:
    """Reference CG loop (ffm.cpp:744-813): S=0, R=-G, V=R; fixed relative
    tolerance and iteration cap; returns the Newton step S.

    With ``D`` (Jacobi preconditioner, hp.cg_precond == "jacobi"): standard
    PCG on the SAME linear system with the SAME stop rule (true residual
    against ||g||^2) — only the Krylov directions change, cutting iteration
    counts ~1.6x and landing capped solves closer to the true Newton step."""
    S = np.zeros_like(G)
    R = -G
    g2 = float((G * G).sum())
    r2 = g2
    if D is None:
        V = R.copy()
        rz = r2
    else:
        Z = R / D
        V = Z.copy()
        rz = float((R * Z).sum())
    it = 0
    while r2 > hp.cg_eps * g2 and it < hp.cg_max_iter:
        it += 1
        Hv = grad_fn_hv(V)
        alpha = rz / float((V * Hv).sum())
        S += alpha * V
        R -= alpha * Hv
        r2 = float((R * R).sum())
        if D is None:
            rz_new = r2
            V = R + (rz_new / rz) * V
        else:
            Z = R / D
            rz_new = float((R * Z).sum())
            V = Z + (rz_new / rz) * V
        rz = rz_new
    return S


def diag_hessian(prob: OracleProblem, params, b: BlockInfo,
                 first_side: bool) -> Arr:
    """Exact diagonal of the block-table Hessian, brute-force from dense
    matrices (the quadratic model behind grad_and_hv):

      cross:  D[d,l] = lam rw[d] + sum_ij Wq_ij X1[i,d]^2 Q1[j,l]^2
      self :  D[d,l] = lam rw[d] + sum_i  dd_i  X1[i,d]^2 Q1[i,l]^2
    """
    hp = prob.hp
    X1 = prob.side_X(b, first_side)
    rw = _reg_weights(prob, b, first_side)
    Wq = _W_matrix(prob)
    if b.kind in ("uu", "vv"):
        other = params["H"][b.f12] if first_side else params["W"][b.f12]
        Q1 = prob.side_X(b, not first_side) @ other
        dd = Wq.sum(axis=1) if b.kind == "uu" else Wq.sum(axis=0)
        D = hp.lam * rw[:, None] + (X1**2).T @ (dd[:, None] * Q1**2)
    else:
        if first_side:
            Q1 = prob.side_X(b, False) @ params["H"][b.f12]  # (n, k)
            D = hp.lam * rw[:, None] + (X1**2).T @ (Wq @ Q1**2)
        else:
            P1 = prob.side_X(b, True) @ params["W"][b.f12]  # (m, k)
            D = hp.lam * rw[:, None] + (X1**2).T @ (Wq.T @ P1**2)
    return np.maximum(D, 1e-300)


def grad_and_hv(prob: OracleProblem, params, b: BlockInfo, first_side: bool):
    """Gradient G and Hessian-vector closure for one table of one block,
    derived brute-force from the dense residual matrix."""
    hp = prob.hp
    yh = predict_dense(prob, params)
    C = _C_matrix(prob, yh)
    Wq = _W_matrix(prob)

    X1 = prob.side_X(b, first_side)
    tbl = params["W"][b.f12] if first_side else params["H"][b.f12]
    rw = _reg_weights(prob, b, first_side)

    if b.kind in ("uu", "vv"):
        # Self block: both sides index the same rows.  Q1 is the *other*
        # table's projection.
        other = params["H"][b.f12] if first_side else params["W"][b.f12]
        Xo = prob.side_X(b, not first_side)
        Q1 = Xo @ other
        if b.kind == "uu":
            z = C.sum(axis=1)  # (m,)
            d = Wq.sum(axis=1)
        else:
            z = C.sum(axis=0)  # rows of this block are items
            d = Wq.sum(axis=0)
        G = hp.lam * rw[:, None] * tbl + X1.T @ (z[:, None] * Q1)

        def hv(Vm):
            phi = X1 @ Vm
            s = d * np.einsum("ik,ik->i", Q1, phi)
            return hp.lam * rw[:, None] * Vm + X1.T @ (s[:, None] * Q1)

    else:
        # Cross block.
        if first_side:
            Q1 = prob.side_X(b, False) @ params["H"][b.f12]  # (n, k)
            G = hp.lam * rw[:, None] * tbl + X1.T @ (C @ Q1)

            def hv(Vm):
                phi = X1 @ Vm  # (m, k)
                t = (Wq * (phi @ Q1.T)) @ Q1  # (m, k)
                return hp.lam * rw[:, None] * Vm + X1.T @ t

        else:
            P1 = prob.side_X(b, True) @ params["W"][b.f12]  # (m, k)
            G = hp.lam * rw[:, None] * tbl + X1.T @ (C.T @ P1)

            def hv(Vm):
                phi = X1 @ Vm  # (n, k)
                t = (Wq.T * (phi @ P1.T)) @ P1  # (n, k)
                return hp.lam * rw[:, None] * Vm + X1.T @ t

    return G, hv


def solve_block_half(
    prob: OracleProblem, params, b: BlockInfo, first_side: bool
) -> Arr:
    """One Gauss-Newton half-step: gradient + CG for the W (first_side) or H
    table of block ``b``, against the *current* params.  Returns the step S
    (does not apply it)."""
    G, hv = grad_and_hv(prob, params, b, first_side)
    # "auto" resolves to PLAIN CG (round 5 — mirrors the solver rule; the
    # sweep tier measured jacobi distorting converged-state quality)
    D = (diag_hessian(prob, params, b, first_side)
         if prob.hp.cg_precond == "jacobi" else None)
    return _cg(hv, G, prob.hp, D)


def oracle_epoch(prob: OracleProblem, params) -> Dict[str, Dict[int, Arr]]:
    """One full alternating sweep in reference order (ffm.cpp:852-870):
    user self blocks, item self blocks, cross blocks; within each block the
    f1-side table then the f2-side table (ffm.cpp:815-850)."""
    params = {
        "W": {k: v.copy() for k, v in params["W"].items()},
        "H": {k: v.copy() for k, v in params["H"].items()},
    }
    for b in prob.layout.epoch_order():
        S = solve_block_half(prob, params, b, True)
        params["W"][b.f12] = params["W"][b.f12] + S
        S = solve_block_half(prob, params, b, False)
        params["H"][b.f12] = params["H"][b.f12] + S
    return params
