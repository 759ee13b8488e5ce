from .mesh import (DIST_TIMEOUT_S, Mesh, MeshConfig, all_gather_host,
                   all_reduce_grads, all_reduce_sum, barrier, broadcast_model,
                   copy_to_model, gather_columns, gather_state_dict,
                   local_devices, make_mesh, param_shardings, shard_model,
                   shard_rows, shard_state_dict, sharded_dim)

__all__ = ["DIST_TIMEOUT_S", "Mesh", "MeshConfig", "all_gather_host",
           "all_reduce_grads", "all_reduce_sum", "barrier", "broadcast_model",
           "copy_to_model", "gather_columns", "gather_state_dict",
           "local_devices", "make_mesh", "param_shardings", "shard_model",
           "shard_rows", "shard_state_dict", "sharded_dim"]
