from .mesh import (Mesh, MeshConfig, all_gather_host, all_reduce_grads,
                   all_reduce_sum, barrier, local_devices, make_mesh,
                   param_shardings, shard_rows)

__all__ = ["Mesh", "MeshConfig", "all_gather_host", "all_reduce_grads",
           "all_reduce_sum", "barrier", "local_devices", "make_mesh",
           "param_shardings", "shard_rows"]
