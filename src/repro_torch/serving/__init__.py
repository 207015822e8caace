"""Serving: paged continuous batching, the dense and wave baselines, their
KV pool, scheduling policies, sampling, speculative decoding and the
resilience plane (``resilience``: fault injection, lifecycle guards,
``serve_with_restarts``).  ``ScheduleCache`` is re-exported from
``core.scheduler``: the shape -> schedule memo the engine and
``kernels.ops.matmul`` consult."""

from repro_torch.core.scheduler import ScheduleCache
from repro_torch.serving.engine import (ContinuousEngine, Engine, Request,
                                        Result, WaveEngine)
from repro_torch.serving.kv_pool import (AdmitPlan, KVPool, PoolAuditError,
                                         ProbeReport, blocks_for)
from repro_torch.serving.policy import (POLICY_NAMES, BestFitPolicy,
                                        FifoPolicy, PendingView,
                                        SchedulerPolicy, SloPreemptPolicy,
                                        SlotView, make_policy,
                                        register_policy)
from repro_torch.serving.resilience import (EngineCrash, FaultPlane,
                                            FaultSpec, InjectedFault,
                                            ResilienceConfig, classify_error,
                                            serve_with_restarts)
from repro_torch.serving.spec import (DraftProvider, ModelDraft, NgramDraft,
                                      make_provider)

__all__ = ["AdmitPlan", "BestFitPolicy", "ContinuousEngine", "DraftProvider",
           "Engine", "EngineCrash", "FaultPlane", "FaultSpec", "FifoPolicy",
           "InjectedFault", "KVPool", "ModelDraft", "NgramDraft",
           "POLICY_NAMES", "PendingView", "PoolAuditError", "ProbeReport",
           "Request", "ResilienceConfig", "Result", "ScheduleCache",
           "SchedulerPolicy", "SloPreemptPolicy", "SlotView", "WaveEngine",
           "blocks_for", "classify_error", "make_policy", "make_provider",
           "register_policy", "serve_with_restarts"]
