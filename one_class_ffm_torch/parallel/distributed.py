"""Process bootstrap for multi-device runs, on ``torch.distributed``.

The counterpart of ``one_class_ffm_tpu/parallel/distributed.py``.  The
reference has no distributed backend (SURVEY.md §2.4: OpenMP on one
shared-memory machine); the JAX package bootstraps ``jax.distributed`` and
lets XLA route the collectives.  Here every rank is one process: it joins a
``torch.distributed`` process group and holds its slice of the rows (see
``mesh.py``).

Typical multi-GPU entry, one process per card:

    torchrun --nproc-per-node 4 -m one_class_ffm_torch items.ffm train.ffm \\
        -p va.ffm --mesh 4 --distributed

``init_distributed()`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and
returns False for a single process.  The backend is NCCL, one card per
rank; gloo only when the caller asks for it (the CPU tests, and ranks that
share one card).  ``spawn`` starts ``n`` ranks of a function on this host,
each a fresh Python process with a ``file://`` rendezvous, and returns
their results; a rank that fails fails the call, and every rank it started
is stopped.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Join the process group of a multi-process run; True when one is
    active with more than one rank, False for a single process (nothing is
    initialized then).

    With no arguments, torchrun's environment: ``WORLD_SIZE`` and ``RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT`` (the ``env://`` rendezvous), and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the card of each rank.
    ``backend``: ``"nccl"`` by default, one card per rank on each host (a
    host with more ranks than cards is an error that names the fix);
    ``"gloo"`` only when asked for: the CPU, or ranks that share a card."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = world_size if world_size is not None else _int_env("WORLD_SIZE")
    if world is None or world <= 1:
        return False
    rank = rank if rank is not None else _int_env("RANK")
    if rank is None:
        raise ValueError("WORLD_SIZE is set but RANK is not: launch the "
                         "ranks with torchrun, or pass rank=")
    if init_method is None:
        if not (os.environ.get("MASTER_ADDR")
                and os.environ.get("MASTER_PORT")):
            raise ValueError(
                "no rendezvous: set MASTER_ADDR and MASTER_PORT (torchrun "
                "does) or pass init_method= (e.g. 'tcp://localhost:29500' "
                "or 'file:///path/to/rdzv')")
        init_method = "env://"
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend nccl needs CUDA cards: "
                               "torch.cuda.is_available() is False")
        local = _int_env("LOCAL_RANK")
        local = rank if local is None else local
        local_world = _int_env("LOCAL_WORLD_SIZE") or world
        cards = torch.cuda.device_count()
        if local_world > cards or local >= cards:
            raise ValueError(
                f"backend nccl runs one rank per card, but this host has "
                f"{local_world} ranks and {cards} card(s): start at most "
                f"{cards} ranks per host (torchrun --nproc-per-node "
                f"{cards}), or pass backend='gloo' to let ranks share a card")
        torch.cuda.set_device(local)
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return True


def rank_device(backend: Optional[str] = None) -> torch.device:
    """This rank's device under an active group: its own card
    (``cuda:LOCAL_RANK``) under NCCL, the CPU under gloo unless the caller
    places the tensors itself."""
    backend = backend or (dist.get_backend() if dist.is_initialized()
                          else "gloo")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_local_slice(global_rows: int) -> slice:
    """The row range this process holds when ``global_rows`` rows are
    sharded over the ``data`` axis of a mesh spanning all processes (rows
    padded to a multiple of the process count)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = global_rows // n_proc
    return slice(pid * per, (pid + 1) * per)


# ---------------------------------------------------------------------------
# spawning ranks on this host
# ---------------------------------------------------------------------------


def _ref(fn: Union[str, Callable]) -> str:
    if isinstance(fn, str):
        return fn
    return f"{fn.__module__}:{fn.__qualname__}"


def _resolve(ref: str) -> Callable:
    mod, _, name = ref.partition(":")
    obj: Any = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def spawn(fn: Union[str, Callable], nprocs: int, args: Sequence = (),
          backend: str = "gloo", workdir: Optional[str] = None,
          timeout: float = 900.0, echo: bool = False) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` ranks of a new process group and
    return each rank's result, in rank order.

    ``fn``: a function importable by its module and name, or a
    ``"module:name"`` string; each rank is a fresh Python process (the
    ``sys.path`` of this one), so the function's module must import without
    side effects.  The ranks meet at a ``file://`` rendezvous in
    ``workdir`` (a new temporary directory by default), which also holds
    the arguments, the results and each rank's output log.  A rank that
    exits non-zero, or a call past ``timeout`` seconds, stops every rank
    and raises with the failing rank's log.  ``echo``: print each rank's
    log, prefixed by its rank, once all have finished."""
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="ocffm_spawn_")
    os.makedirs(workdir, exist_ok=True)
    job = os.path.join(workdir, "job.pkl")
    rdzv = os.path.join(workdir, "rdzv")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    with open(job, "wb") as fh:
        pickle.dump(dict(fn=_ref(fn), args=tuple(args), backend=backend,
                         init_method=f"file://{rdzv}", world=nprocs), fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs, logs = [], []
    try:
        for r in range(nprocs):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 f"from {__name__} import _rank_main; "
                 f"_rank_main({job!r}, {r})"],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        t_end = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # a moment for the others to fail too: the first to exit
                # may be a peer that lost its connection, not the cause
                t_grace = time.monotonic() + 2.0
                while (time.monotonic() < t_grace
                       and any(p.poll() is None for p in procs)):
                    time.sleep(0.05)
                codes = [p.poll() for p in procs]
                raise RuntimeError("\n".join(
                    f"rank {r} of {nprocs} exited with code {c}:\n"
                    f"{_tail(workdir, r)}"
                    for r, c in enumerate(codes) if c not in (None, 0)))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                raise RuntimeError(
                    f"ranks not done after {timeout:.0f} s:\n"
                    f"{_tail(workdir, 0)}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if echo:
        for r in range(nprocs):
            with open(os.path.join(workdir, f"rank{r}.log")) as fh:
                for line in fh:
                    print(f"[rank {r}] {line}", end="")
    out = []
    for r in range(nprocs):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    if own_dir:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return out


def _tail(workdir: str, rank: int, n: int = 6000) -> str:
    try:
        with open(os.path.join(workdir, f"rank{rank}.log")) as fh:
            return fh.read()[-n:]
    except OSError:
        return "(no log)"


def _rank_main(job_path: str, rank: int) -> None:
    """One spawned rank: join the group, run the job's function, write its
    result beside the job."""
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    init_distributed(backend=job["backend"], init_method=job["init_method"],
                     rank=rank, world_size=job["world"])
    try:
        out = _resolve(job["fn"])(*job["args"])
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(os.path.dirname(job_path), f".out{rank}.pkl")
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, os.path.join(os.path.dirname(job_path), f"out{rank}.pkl"))
