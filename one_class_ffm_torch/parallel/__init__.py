from .mesh import make_mesh, replicate_params, shard_data, shard_state

__all__ = ["make_mesh", "shard_data", "shard_state", "replicate_params"]
