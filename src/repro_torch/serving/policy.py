"""Scheduling policies of the paged engine (port of
``repro.serving.policy``): which queued request a free slot admits, and
which decoding slot to evict for a request at risk.

  ``fifo``          strict arrival order; one reservation the pool cannot
                    host blocks every request behind it.
  ``best_fit``      the queued request whose reservation, after prefix
                    credit (``KVPool.probe``), is the largest that still
                    fits; a head older than ``age_cap_s`` goes first.
  ``slo_preempt``   FIFO, except that the most urgent request past
                    ``risk_frac`` of its ``Request.ttft_slo`` jumps the
                    queue when it fits, and when it does not, a decoding
                    victim (most reclaimable blocks, least progress) is
                    preempted: its produced tokens kept, its KV registered
                    in the prefix cache, and it re-queues to resume.
  ``model_fit``     admission ordered by modeled step costs
                    (:class:`StepCosts`): deadline urgency, then arrival
                    order while the head fits, else best-fit packing with
                    the modeled service cost breaking ties; best-effort
                    admissions are held while a deadline starves.
  ``model_preempt`` ``model_fit`` plus eviction priced by modeled loss
                    (one resume chunk, plus the victim's remaining decode
                    when it has a deadline of its own), and the rescue of
                    a starving best-effort head.

Policies are pure decision functions over immutable views
(:class:`PendingView`, :class:`SlotView`); the engine does every
mutation and counts the outcomes (``engine.admissions``,
``engine.resumes``, ``engine.preemptions``, ``engine.pool_util*``).  New
policies subclass :class:`SchedulerPolicy` and register with
:func:`register_policy`; ``ContinuousEngine(policy="name")`` resolves
through :func:`make_policy`.

``model_*`` take their costs from ``WorkloadModel(cfg, geom).step_costs()``
(``repro_torch.planner``); without one they run on :class:`StepCosts`'s
shape-free prior (a chunk batch costs three decode steps).  Only ratios
are compared, so the unit cancels.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

# StepCosts lives in planner.model; policies and callers use it from here
from repro_torch.planner.model import StepCosts  # noqa: F401
from repro_torch.serving.kv_pool import ProbeReport


@dataclasses.dataclass(frozen=True)
class PendingView:
    """One queued request, as policies see it."""

    index: int                  # position in the queue (0 = head)
    rid: int
    prompt_len: int             # tokens to prefill (resume tail included)
    new_tokens: int             # remaining decode budget
    priority: int
    ttft_slo: float | None      # seconds; None = no deadline
    waited_s: float             # now - submit time
    resumed: bool               # the request has produced tokens
    preemptions: int
    probe: ProbeReport | None   # pool probe (None when not asked for)


@dataclasses.dataclass(frozen=True)
class SlotView:
    """One occupied engine slot, as policies see it."""

    index: int
    rid: int
    phase: str                  # "prefill" | "decode"
    priority: int
    produced: int               # tokens produced so far
    remaining: int              # decode budget left
    reclaimable_blocks: int     # blocks freed outright if evicted
    preemptions: int
    has_slo: bool


class SchedulerPolicy:
    """``select_admission`` returns the queue index to admit next (None:
    hold the queue this step); ``select_victim`` the slot to preempt (None:
    none).  Both are asked once a step with fresh views; an admission can
    still back off, so decisions must be safe to repeat."""

    name = "base"
    #: reads block-reservation probes, so needs the paged pool
    requires_pool = False
    #: False skips the per-request ``KVPool.probe`` when views are built
    needs_probes = True
    #: True when ``select_victim`` can name a slot
    preempts = False

    def select_admission(self, pending: list[PendingView],
                         now: float) -> int | None:
        raise NotImplementedError

    def select_victim(self, pending: list[PendingView],
                      slots: list[SlotView | None],
                      now: float) -> int | None:
        return None


class FifoPolicy(SchedulerPolicy):
    """Strict arrival order."""

    name = "fifo"
    needs_probes = False

    def select_admission(self, pending, now):
        return 0 if pending else None


class BestFitPolicy(SchedulerPolicy):
    """Among requests whose reservation fits now, the one taking the most
    fresh blocks (priority first, earliest on ties); a head older than
    ``age_cap_s`` is forced through in FIFO order (the starvation
    bound)."""

    name = "best_fit"
    requires_pool = True

    def __init__(self, age_cap_s: float = 30.0):
        if age_cap_s <= 0:
            raise ValueError("age_cap_s must be positive")
        self.age_cap_s = age_cap_s

    def select_admission(self, pending, now):
        if not pending:
            return None
        if pending[0].waited_s > self.age_cap_s:
            return 0
        fits = [p for p in pending if p.probe is not None and p.probe.fits_now]
        if not fits:
            return None
        best = max(fits, key=lambda p: (p.priority, p.probe.need_new,
                                        -p.index))
        return best.index


def _at_risk(pending, risk_frac):
    """Requests with a TTFT deadline that have waited ``risk_frac`` of it
    and not produced a token yet (a resumed one never re-triggers)."""
    return [p for p in pending
            if p.ttft_slo is not None and not p.resumed
            and p.waited_s >= risk_frac * p.ttft_slo]


class SloPreemptPolicy(SchedulerPolicy):
    """FIFO admission, the most urgent at-risk request first when it fits;
    when it does not (or no slot is free), a decoding victim with the most
    reclaimable blocks and the least progress, skipping slots preempted
    ``max_preemptions`` times and slots of higher priority."""

    name = "slo_preempt"
    requires_pool = True
    preempts = True

    def __init__(self, risk_frac: float = 0.5, max_preemptions: int = 2,
                 min_progress: int = 1):
        if not 0 < risk_frac <= 1:
            raise ValueError("risk_frac must be in (0, 1]")
        self.risk_frac = risk_frac
        self.max_preemptions = max_preemptions
        self.min_progress = min_progress

    def select_admission(self, pending, now):
        if not pending:
            return None
        at_risk = _at_risk(pending, self.risk_frac)
        if at_risk:
            target = max(at_risk, key=lambda p: (p.priority, p.waited_s))
            if target.probe is None or target.probe.fits_now:
                return target.index
        return 0

    def select_victim(self, pending, slots, now):
        at_risk = _at_risk(pending, self.risk_frac)
        if not at_risk:
            return None
        target = max(at_risk, key=lambda p: (p.priority, p.waited_s))
        free = any(s is None for s in slots)
        if free and target.probe is not None and target.probe.fits_now:
            return None                 # plain admission serves it
        cands = [s for s in slots
                 if s is not None and s.phase == "decode"
                 and s.produced >= self.min_progress
                 and s.preemptions < self.max_preemptions
                 and s.priority <= target.priority]
        if not cands:
            return None
        victim = max(cands, key=lambda s: (s.reclaimable_blocks,
                                           -s.produced, -s.index))
        return victim.index


class ModelFitPolicy(SchedulerPolicy):
    """Admission on modeled step costs:

      1. a head older than ``age_cap_s`` goes first;
      2. the most urgent at-risk request is admitted when it fits (the
         cheaper first token breaking urgency ties), and when it does not,
         every other admission is held;
      3. otherwise arrival order while the head fits; when it does not,
         the hole is filled best-fit (modeled service cost breaking ties)
         at most ``max_bypass`` times before the pool is held for it."""

    name = "model_fit"
    requires_pool = True

    def __init__(self, costs: StepCosts | None = None,
                 age_cap_s: float = 30.0, risk_frac: float = 0.5,
                 max_bypass: int = 1):
        if age_cap_s <= 0:
            raise ValueError("age_cap_s must be positive")
        if not 0 < risk_frac <= 1:
            raise ValueError("risk_frac must be in (0, 1]")
        if max_bypass < 0:
            raise ValueError("max_bypass must be >= 0")
        self.costs = costs or StepCosts()
        self.age_cap_s = age_cap_s
        self.risk_frac = risk_frac
        self.max_bypass = max_bypass
        # how often the current unfittable head has been bypassed
        self._head_rid: int | None = None
        self._bypassed = 0

    def select_admission(self, pending, now):
        if not pending:
            return None
        if pending[0].waited_s > self.age_cap_s:
            return 0
        at_risk = _at_risk(pending, self.risk_frac)
        if at_risk:
            target = max(at_risk,
                         key=lambda p: (p.priority, p.waited_s,
                                        -self.costs.ttft_cost(p.prompt_len)))
            if target.probe is None or target.probe.fits_now:
                return target.index
            return None                 # hold the pool for the deadline
        fits = [p for p in pending
                if p.probe is not None and p.probe.fits_now]
        if any(p.index == 0 for p in fits):
            self._head_rid, self._bypassed = None, 0
            return 0
        if pending[0].rid != self._head_rid:
            self._head_rid, self._bypassed = pending[0].rid, 0
        if self._bypassed >= self.max_bypass or not fits:
            return None                 # starving head: hold the pool
        self._bypassed += 1
        best = max(fits,
                   key=lambda p: (p.priority, p.probe.need_new,
                                  -self.costs.service_cost(p.prompt_len,
                                                           p.new_tokens),
                                  -p.index))
        return best.index


class ModelPreemptPolicy(ModelFitPolicy):
    """:class:`ModelFitPolicy` admission plus eviction priced by modeled
    loss; once the bypass bound is spent on an unfittable best-effort
    head, a decoder without a deadline is evicted to rescue it."""

    name = "model_preempt"
    preempts = True

    def __init__(self, costs: StepCosts | None = None,
                 age_cap_s: float = 30.0, risk_frac: float = 0.5,
                 max_bypass: int = 1, max_preemptions: int = 2,
                 min_progress: int = 1):
        super().__init__(costs=costs, age_cap_s=age_cap_s,
                         risk_frac=risk_frac, max_bypass=max_bypass)
        self.max_preemptions = max_preemptions
        self.min_progress = min_progress

    def _evict_loss(self, s: SlotView) -> float:
        loss = self.costs.chunk_cost
        if s.has_slo:
            loss += s.remaining * self.costs.decode_cost
        return loss

    def _candidates(self, slots, target, *, spare_slo: bool):
        return [s for s in slots
                if s is not None and s.phase == "decode"
                and s.produced >= self.min_progress
                and s.preemptions < self.max_preemptions
                and s.priority <= target.priority
                and not (spare_slo and s.has_slo)]

    def _best_victim(self, cands):
        return max(cands, key=lambda s: (s.reclaimable_blocks,
                                         -self._evict_loss(s),
                                         -s.produced, -s.index))

    def select_victim(self, pending, slots, now):
        at_risk = _at_risk(pending, self.risk_frac)
        if at_risk:
            target = max(at_risk, key=lambda p: (p.priority, p.waited_s))
            free = any(s is None for s in slots)
            if free and target.probe is not None and target.probe.fits_now:
                return None
            cands = self._candidates(slots, target, spare_slo=False)
            return self._best_victim(cands).index if cands else None
        if not pending or self._bypassed < self.max_bypass:
            return None
        head = pending[0]
        if head.probe is None or head.probe.fits_now:
            return None
        cands = self._candidates(slots, head, spare_slo=True)
        return self._best_victim(cands).index if cands else None


_REGISTRY: dict[str, Callable[..., SchedulerPolicy]] = {}


def register_policy(name: str,
                    factory: Callable[..., SchedulerPolicy]) -> None:
    """Expose a policy as ``ContinuousEngine(policy=name)``."""
    _REGISTRY[name] = factory


register_policy("fifo", FifoPolicy)
register_policy("best_fit", BestFitPolicy)
register_policy("slo_preempt", SloPreemptPolicy)
register_policy("model_fit", ModelFitPolicy)
register_policy("model_preempt", ModelPreemptPolicy)

#: the CLI's choices (``launch/serve.py``)
POLICY_NAMES = ("fifo", "best_fit", "slo_preempt", "model_fit",
                "model_preempt")


def make_policy(name: str, **kwargs) -> SchedulerPolicy:
    """Instantiate a registered policy by name."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None
    return factory(**kwargs)
