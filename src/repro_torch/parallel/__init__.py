from .sharding import (ShardCtx, gather_params, local_ctx, param_shardings,
                       shard_params)

__all__ = ["ShardCtx", "local_ctx", "param_shardings", "shard_params",
           "gather_params"]
