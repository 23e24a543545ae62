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
placement: rows and the stream on ``data``, per-feature arrays replicated,
block tables replicated or, with ``model_min_rows`` > 0 on a 2-D mesh,
those of at least that many rows row-sharded across the ranks of the
``model`` axis (the web-scale layout, BASELINE.json configs[4]).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .mesh import Mesh, shard_data, shard_state


def make_global(arr, mesh: Mesh, spec: str = "data") -> torch.Tensor:
    """This rank's part of the full host value ``arr`` (every process passes
    the same array): its rows for ``spec="data"``, its model rows for
    ``spec="model"``, a copy for ``spec="replicated"``, on
    ``mesh.device``."""
    t = torch.as_tensor(arr)
    if spec == "replicated":
        return t.to(mesh.device, copy=True)
    if spec == "model":
        return t[mesh.model_rows(t.shape[0])].contiguous().to(mesh.device)
    if spec != "data":
        raise ValueError(f"placement {spec!r}: data, model or replicated")
    return t[mesh.rows(t.shape[0])].contiguous().to(mesh.device)


def make_global_data(data_host: Dict[str, Any], mesh: Mesh,
                     axis: str = "data") -> Dict[str, Any]:
    """The multi-host form of ``mesh.shard_data`` (same placement)."""
    return shard_data(data_host, mesh)


def make_global_state(state_host: Dict[str, Any], mesh: Mesh,
                      axis: str = "data", model_min_rows: int = 0,
                      model_axis: str = "model",
                      data: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The multi-host form of ``mesh.shard_state``.  ``model_min_rows`` > 0
    row-shards every block table with at least that many rows across the
    ranks of ``model_axis`` (a table whose rows do not divide it is an
    error naming ``d_multiple``); ``data``: the rank's part of the data,
    which names a two-tier side's head chunks."""
    if model_min_rows and mesh.n_model <= 1:
        # no model axis: the tables are replicated (the JAX package's
        # shard_params_model on a mesh without one)
        model_min_rows = 0
    return shard_state(state_host, mesh,
                       model_min_rows=model_min_rows or None, data=data)
