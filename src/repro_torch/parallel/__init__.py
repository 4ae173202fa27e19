from .sharding import ShardCtx, local_ctx

__all__ = ["ShardCtx", "local_ctx"]
