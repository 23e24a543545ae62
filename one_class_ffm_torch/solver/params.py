"""Hyperparameters (reference Parameter, ffm.h:42-49 + train.cpp flags).

A copy of ``one_class_ffm_tpu/solver/params.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HyperParams:
    k: int = 4  # rank (-k)
    lam: float = 1e-5  # L2 coefficient lambda (-l)
    omega: float = 0.1  # negative-pair weight (-w)
    r: float = -1.0  # imputed negative rating (-r)
    nr_pass: int = 20  # epochs (-t)
    self_side: bool = True  # False under --ns: cross blocks only
    freq: bool = False  # --freq: frequency-weighted lambda
    cg_max_iter: int = 20  # CG iteration cap (ffm.cpp:761)
    cg_eps: float = 9e-2  # relative CG tolerance ||r||^2 <= eps*||g||^2
    # "jacobi": diagonal-preconditioned CG — same linear system, same stop
    # rule (true residual vs ||g||^2), fewer iterations and capped solves
    # land closer to the true Newton step.  "none": the reference's plain
    # CG (ffm.cpp:744-813).  "auto" (default): jacobi everywhere except
    # bf16 storage with the plain COO ops, where bf16-accumulated Hv noise
    # defeats the preconditioner (docs/PERF.md; the blocked-sorted ops
    # accumulate in f32 and restore it).
    cg_precond: str = "auto"
