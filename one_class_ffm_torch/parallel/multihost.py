"""Multi-host (multi-process) placement of the solver's arrays.

The counterpart of ``one_class_ffm_tpu/parallel/multihost.py``.  There each
process addresses only its own devices, so globally sharded arrays are
assembled with ``jax.make_array_from_process_local_data``.  Here every rank
is a process holding plain tensors of its own slice, so these functions
reduce to ``mesh.py``'s slicing; they keep the JAX package's names.  Every
process calls ``make_global_data`` / ``make_global_state`` with the SAME
full host arrays (cheap at the host layer: data loading is deterministic
from the seed), and gets back its rank's slice on its device.

Pairs with ``distributed.init_distributed`` and ``mesh.shard_data``'s
placement (rows and the stream on ``data``, tables and per-feature arrays
replicated).  Only the 1-D ``data`` mesh runs: ``model_min_rows > 0``
(tables row-sharded on a model axis) raises, naming ROADMAP A11b.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .mesh import A11B, Mesh, shard_data, shard_state


def make_global(arr, mesh: Mesh, spec: str = "data") -> torch.Tensor:
    """This rank's part of the full host value ``arr`` (every process passes
    the same array): its rows for ``spec="data"``, a copy for
    ``spec="replicated"``, on ``mesh.device``."""
    t = torch.as_tensor(arr)
    if spec == "replicated":
        return t.to(mesh.device, copy=True)
    if spec != "data":
        raise NotImplementedError(f"placement {spec!r}: {A11B}")
    return t[mesh.rows(t.shape[0])].contiguous().to(mesh.device)


def make_global_data(data_host: Dict[str, Any], mesh: Mesh,
                     axis: str = "data") -> Dict[str, Any]:
    """The multi-host form of ``mesh.shard_data`` (same placement)."""
    return shard_data(data_host, mesh)


def make_global_state(state_host: Dict[str, Any], mesh: Mesh,
                      axis: str = "data", model_min_rows: int = 0,
                      model_axis: str = "model") -> Dict[str, Any]:
    """The multi-host form of ``mesh.shard_state``.  ``model_min_rows`` > 0
    (the web-scale layout: tables row-sharded across hosts on
    ``model_axis``) raises: ROADMAP A11b."""
    if model_min_rows:
        raise NotImplementedError(
            f"block tables row-sharded on the {model_axis} axis: {A11B}")
    return shard_state(state_host, mesh)
