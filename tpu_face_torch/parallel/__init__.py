from .sharding import (data_parallel_mesh, infer_sharded, shard_batch,
                       track_sharded)

__all__ = ["data_parallel_mesh", "shard_batch", "infer_sharded",
           "track_sharded"]
