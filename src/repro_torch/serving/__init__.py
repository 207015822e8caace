"""Paged continuous-batching serving."""

from repro_torch.serving.engine import ContinuousEngine, Request, Result
from repro_torch.serving.kv_pool import KVPool, PoolAuditError

__all__ = ["ContinuousEngine", "KVPool", "PoolAuditError", "Request",
           "Result"]
