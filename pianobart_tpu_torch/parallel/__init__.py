from .mesh import (Mesh, init_from_env, make_mesh, put_batch_fn, shard_batch,
                   single_device_mesh, use_mesh)
from .sp import encode_sp

__all__ = ["Mesh", "init_from_env", "make_mesh", "put_batch_fn", "shard_batch",
           "single_device_mesh", "use_mesh", "encode_sp"]
