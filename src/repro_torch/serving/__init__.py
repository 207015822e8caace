"""Paged continuous-batching serving: the engine, its KV pool, scheduling
policies, sampling and speculative decoding."""

from repro_torch.serving.engine import ContinuousEngine, Request, Result
from repro_torch.serving.kv_pool import KVPool, PoolAuditError, ProbeReport
from repro_torch.serving.policy import (POLICY_NAMES, SchedulerPolicy,
                                        make_policy, register_policy)
from repro_torch.serving.spec import (DraftProvider, ModelDraft, NgramDraft,
                                      make_provider)

__all__ = ["ContinuousEngine", "DraftProvider", "KVPool", "ModelDraft",
           "NgramDraft", "POLICY_NAMES", "PoolAuditError", "ProbeReport",
           "Request", "Result", "SchedulerPolicy", "make_policy",
           "make_provider", "register_policy"]
