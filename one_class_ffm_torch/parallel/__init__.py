from .mesh import (
    make_mesh,
    make_mesh2,
    replicate_params,
    shard_data,
    shard_params_model,
    shard_state,
)

__all__ = ["make_mesh", "make_mesh2", "shard_data", "shard_state",
           "replicate_params", "shard_params_model"]
