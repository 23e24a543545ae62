"""CUDA graphs of a Newton solve's CG iterations: the port's counterpart, on
one process on the card, of the reference's jitted ``lax.while_loop``
(jax_solver.py FFMSolver._cg).

For each table a solver solves (a key of its Hv closure: block kind, block,
side) ``CgGraphs`` captures ``group`` iterations, each the Hv closure and
the recurrence kernel (``kernels.cg_step``, csrc/cg_ops.cu), once, on
buffers that stay put: the closure's per-solve inputs (the other side's
cache or stream, the dense k x k term, the head stream: ``hv.cg_inputs``)
and the recurrence's vectors and scalars, shared by every key of the same
shape.  A solve copies its inputs into those buffers, starts the
recurrence there (``kernels.cg_init``, eager), then replays the graph and
reads the done flag and the count through pinned memory once per replay
(``sparse_ops.cg_read``) until the flag is set.  Iterations after the stop
are exact no-ops on the card, so the table and the count equal those of
one iteration per host test.  The graphs share one memory pool: nothing a
capture allocates outlives it, so a replay's temporaries never hold
another graph's data.

A capture records launches, not the wrappers' Python: every list plan a
captured launch reads is held by its graph (``kernels.hold_plans``), each
replay adds the captured launches to the launch counts, and a failed
capture or replay raises.  Each capture is counted, with the host seconds
of its eager warm Hv and the capture, and is a span ``cg.capture`` in a
trace.  Nothing here runs on the CPU or under a mesh, whose Hv's
all-reduce a graph cannot hold.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch

from ..ops import kernels
from ..ops.sparse_ops import cg_init, cg_read, cg_step
from ..utils.profiling import span

Tensor = torch.Tensor


@dataclass
class CgGraph:
    """One captured group of iterations: the graph, the launches it
    records and the list plans its launches read (held for the graph's
    life)."""

    graph: Any
    group: int  # iterations per replay
    launches: Dict[str, int]
    plans: List[Any]
    ptrs: Dict[str, int]  # the addresses the capture read, by buffer name
    masked: int = 0  # iterations replayed after their solve's stop


@dataclass
class CgGraphs:
    """A solver's CG graphs, their buffers and their counts."""

    device: torch.device
    graphs: Dict[Any, CgGraph] = field(default_factory=dict)
    buffers: Dict[Tuple, Tensor] = field(default_factory=dict)
    pool: Any = None
    stream: Any = None
    # captures made and the host seconds they took (a solver hands its
    # ``cg_counts``)
    counts: Dict[str, Any] = field(
        default_factory=lambda: dict(captures=0, capture_s=0.0))

    def buffer(self, name: str, shape, dtype) -> Tensor:
        """The persistent buffer of an input ``name`` of this shape and
        dtype (shared by every key that has one)."""
        key = (name, tuple(shape), dtype)
        buf = self.buffers.get(key)
        if buf is None:
            buf = self.buffers[key] = torch.empty(
                tuple(shape), dtype=dtype, device=self.device)
        return buf

    def _state(self, shape, storage, jacobi: bool,
               max_iter: int) -> kernels.CgState:
        key = ("cg", tuple(shape), storage, jacobi, max_iter)
        st = self.buffers.get(key)
        if st is None:
            st = self.buffers[key] = kernels.cg_state(
                tuple(shape), storage, jacobi, max_iter, self.device)
        return st

    def solve(self, hv, G: Tensor, D, storage, eps: float, max_iter: int,
              group: int) -> Tuple[Tensor, int, int]:
        """(S, count, replays) of one solve, ``group`` iterations a replay:
        ``hv`` a solver's closure (``FFMSolver._hv_closure``: its
        ``cg_key``, ``cg_inputs`` and ``cg_make``).  A solve whose buffers
        are not those its graph was captured on raises."""
        key = getattr(hv, "cg_key", None)
        if key is None:
            raise ValueError("the CG graph path takes a solver's Hv closure "
                             "(FFMSolver._hv_closure), which carries its key "
                             "and inputs")
        key = (key, group)
        st = self._state(G.shape, storage, D is not None, max_iter)
        bufs = {}
        for name, t in hv.cg_inputs.items():
            buf = self.buffer(name, t.shape, t.dtype)
            if buf.data_ptr() != t.data_ptr():
                buf.copy_(t)
            bufs[name] = buf
        ptrs = _ptrs(bufs, st)
        cg_init(G, D, storage, eps, max_iter, out=st)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(hv.cg_make(bufs), st,
                                                     group, ptrs)
        elif entry.ptrs != ptrs:
            moved = sorted(k for k in ptrs if entry.ptrs.get(k) != ptrs[k])
            raise RuntimeError(f"CG graph {key}: its buffers {moved} are "
                               f"not those it was captured on (an input "
                               f"changed shape or dtype)")
        limit = -(-max_iter // group) + 1
        for replays in range(1, limit + 1):
            entry.graph.replay()
            kernels.count_launches(entry.launches)
            done, it = cg_read(st)
            if done:
                entry.masked += replays * group - it
                return st.S.clone(), it, replays
        raise RuntimeError(f"the CG graph ran {limit} replays of {group} "
                           f"iterations without its stop")

    def _capture(self, hv, st: kernels.CgState, group: int,
                 ptrs: Dict[str, int]) -> CgGraph:
        """Capture ``group`` iterations of ``hv`` and the recurrence on the
        state's buffers, after one eager Hv that builds the lists' plans
        (their first use reads the card from the host, which a capture
        refuses)."""
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        with span("cg.capture"):
            hv(st.Vs)
            graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with kernels.hold_plans() as plans, \
                    torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool)
                try:
                    for _ in range(group):
                        cg_step(st, hv(st.Vs))
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            cur.wait_stream(self.stream)
        self.counts["captures"] += 1
        self.counts["capture_s"] += time.perf_counter() - t0
        after = kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        kernels.count_launches({k: -n for k, n in launches.items()})
        return CgGraph(graph=graph, group=group, launches=launches,
                       plans=list(plans), ptrs=ptrs)


def _ptrs(bufs: Dict[str, Tensor], st: kernels.CgState) -> Dict[str, int]:
    """The addresses of a solve's input buffers and of its state's."""
    out = {name: t.data_ptr() for name, t in bufs.items()}
    for name in ("S", "R", "V", "Vs", "D", "sc", "part"):
        t = getattr(st, name)
        out["cg." + name] = 0 if t is None else t.data_ptr()
    return out
