"""Sharded-native checkpoints on ``torch.distributed.checkpoint`` (DCP).

The counterpart of ``one_class_ffm_tpu/utils/orbax_ckpt.py``: the block
tables are saved as the state holds them, so that a 2-D mesh's row-sharded
tables are written without gathering them to one rank, and restore onto any
topology.  Each table goes to DCP as a ``DTensor`` on the ``DeviceMesh`` of
the port's ``Mesh`` (``Mesh.device_mesh``, ranks in the same row-major
``data x model`` order): a row-sharded table with placements ``[Replicate(),
Shard(0)]`` (each rank hands DCP only the model rows it holds; DCP writes
each row block once), a replicated table with ``[Replicate(),
Replicate()]``.  One process with no mesh saves and loads plain tensors.
Tables are saved at their padded dims and storage dtype, as the original
saves the state's params; the trainer pads or cuts them to its own dims on
restore (pad rows are zero).

The layout matches the original's: a ``step_{epoch}/`` directory per save
and a meta JSON with the original's keys (``epoch``, ``step_dir``, ``k``,
``layout``).  The files are DCP's, not orbax's (orbax needs jax and
tensorstore): neither package reads the other's, and a directory that holds
only the JAX package's ``orbax_meta.json`` is not a checkpoint here.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

META = "dcp_meta.json"
JAX_META = "orbax_meta.json"  # the JAX package's orbax checkpoints

# {f12: {"W" | "H": (padded rows of the whole table, row-sharded on the
# model axis?)}}: how a mesh holds each table (FFMSolver.table_specs)
Specs = Dict[int, Dict[str, Tuple[int, bool]]]


def available() -> bool:
    try:
        import torch.distributed.checkpoint  # noqa: F401
        from torch.distributed.tensor import DTensor  # noqa: F401

        return True
    except Exception:
        return False


def _placements(sharded: bool):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate(), Shard(0) if sharded else Replicate()]


def _distributed(mesh) -> bool:
    """A mesh of more than one rank (one rank saves as one process)."""
    return mesh is not None and mesh.size * mesh.n_model > 1


@contextlib.contextmanager
def _quiet(one_process: bool):
    """DCP warns on every call without a group that it assumes one
    process, and on every save into a step directory saved before that it
    replaces it: both are the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="Detected an existing checkpoint")
        if one_process:
            warnings.filterwarnings(
                "ignore", message="torch.distributed is (disabled|unavail)")
        yield


def save(ckpt_dir: str, params, epoch: int,
         meta: Optional[Dict[str, Any]] = None, *, mesh=None,
         specs: Optional[Specs] = None) -> int:
    """Save the block tables and the metadata under ``ckpt_dir``; returns the
    bytes of the files this rank wrote.  On a mesh every rank calls it (DCP's
    save is collective) with the tables as its state holds them and
    ``specs``; the mesh's writer (data and model rank 0) then writes the
    meta JSON, and every rank returns after it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemWriter

    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{epoch}"))
    os.makedirs(path, exist_ok=True)
    dist = _distributed(mesh)
    if dist:
        from torch.distributed.tensor import DTensor

        dm = mesh.device_mesh()
        tree = {str(f12): {
            name: DTensor.from_local(
                t, dm, _placements(specs[f12][name][1]), run_check=False,
                shape=torch.Size((specs[f12][name][0], t.shape[1])),
                stride=(t.shape[1], 1))
            for name, t in blk.items()} for f12, blk in params.items()}
    else:
        tree = {str(f12): dict(blk) for f12, blk in params.items()}
    with _quiet(not dist):
        # a step directory saved before is replaced (the trainer saves the
        # last epoch twice, as the original does)
        dcp.save(tree, storage_writer=FileSystemWriter(path, overwrite=True),
                 no_dist=not dist)
    # DCP's file writer names each rank's files __{rank}_{i}.distcp
    rank = torch.distributed.get_rank() if dist else 0
    written = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path) if f.startswith(f"__{rank}_"))
    if not dist or (mesh.rank == 0 and mesh.model_rank == 0):
        doc = dict(epoch=epoch, step_dir=f"step_{epoch}",
                   format="torch.distributed.checkpoint", **(meta or {}))
        tmp = os.path.join(ckpt_dir, f".{META}.tmp")
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, os.path.join(ckpt_dir, META))
    if dist:  # every rank returns with the meta written
        torch.distributed.barrier()
    return written


def read_meta(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, META)) as fh:
        return json.load(fh)


def table_shapes(ckpt_dir: str, step_dir: Optional[str] = None):
    """{f12: {"W" | "H": (rows, k, dtype)}} of the tables in the checkpoint
    (from DCP's metadata file alone)."""
    from torch.distributed.checkpoint import FileSystemReader

    step_dir = step_dir or read_meta(ckpt_dir)["step_dir"]
    md = FileSystemReader(os.path.join(ckpt_dir, step_dir)).read_metadata()
    out: Dict[int, Dict[str, Any]] = {}
    for key, tmd in md.state_dict_metadata.items():
        f12, name = key.split(".")
        out.setdefault(int(f12), {})[name] = (
            *tuple(tmd.size), tmd.properties.dtype)
    return out


def load(ckpt_dir: str, *, mesh=None, specs: Optional[Specs] = None,
         dtype: Optional[torch.dtype] = None):
    """Restore ``(params, epoch)``.

    With no mesh: the whole tables as DCP saved them (padded dims, storage
    dtype) as host tensors, whatever topology wrote them.  On a mesh (every
    rank calls it, with ``specs`` and ``dtype``): this rank's tables as its
    state holds them, on its device, each rank reading only its model rows
    of a row-sharded table; a checkpoint of other padded dims is padded or
    cut (zero rows), which needs its rows to pad to the same multiple of
    the model axis."""
    import torch.distributed.checkpoint as dcp

    meta = read_meta(ckpt_dir)
    path = os.path.abspath(os.path.join(ckpt_dir, meta["step_dir"]))
    shapes = table_shapes(ckpt_dir, meta["step_dir"])
    if not _distributed(mesh):
        tree = {str(f12): {name: torch.empty((rows, k), dtype=dt)
                           for name, (rows, k, dt) in blk.items()}
                for f12, blk in shapes.items()}
        with _quiet(True):
            dcp.load(tree, checkpoint_id=path, no_dist=True)
        return ({int(f12): blk for f12, blk in tree.items()},
                int(meta["epoch"]))
    from torch.distributed.tensor import empty as dt_empty

    dm = mesh.device_mesh()
    tree = {}
    for f12, blk in specs.items():
        tree[str(f12)] = {}
        for name, (rows, sharded) in blk.items():
            saved, k, _ = shapes[f12][name]
            if sharded and -(-saved // mesh.n_model) * mesh.n_model != rows:
                raise ValueError(
                    f"table {name}[{f12}] was saved with {saved} rows, which "
                    f"do not pad to this mesh's {rows} on a model axis of "
                    f"{mesh.n_model}: restore it without a mesh first")
            tree[str(f12)][name] = dt_empty(
                (saved, k), dtype=dtype, device_mesh=dm,
                placements=_placements(sharded))
    dcp.load(tree, checkpoint_id=path)
    params = {}
    for f12, blk in specs.items():
        params[f12] = {}
        for name, (rows, sharded) in blk.items():
            t = tree[str(f12)][name].to_local()
            want = rows // mesh.n_model if sharded else rows
            t = t[:want]
            if t.shape[0] < want:
                t = torch.nn.functional.pad(t, (0, 0, 0, want - t.shape[0]))
            params[f12][name] = t.to(mesh.device).contiguous()
    return params, int(meta["epoch"])


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, META))


def has_jax_checkpoint(ckpt_dir: str) -> bool:
    """A directory of the JAX package's orbax checkpoints and none of the
    port's."""
    return (os.path.exists(os.path.join(ckpt_dir, JAX_META))
            and not has_checkpoint(ckpt_dir))
