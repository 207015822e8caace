"""The serving fault-tolerance plane (a port of
``repro.serving.resilience``; ``docs/RELIABILITY.md``): deterministic
fault injection, the lifecycle-guard configuration, error
classification and the warm-restart driver.

* :class:`FaultPlane`: a seeded, schedule-driven injector with seams at
  KV-pool allocation (``reserve`` / ``extend`` denials), the engine's
  dispatches (raise at engine step N, before the step's model call),
  draft providers (garbage drafts), request payloads (poison: a rid
  whose dispatch raises) and the whole engine (:class:`EngineCrash`, the
  warm-restart drill).  Schedules are plain dicts
  (:meth:`FaultPlane.to_schedule` / :meth:`FaultPlane.from_schedule`);
  the firing machinery is ``runtime.faults.FailureInjector``.
* :class:`ResilienceConfig`: the engine's guard knobs (load-shedding
  bound, bounded admission retry with exponential backoff, dispatch
  retry budget, adaptive ``spec_k``).  Every default is the unguarded
  behaviour, so a default config changes nothing.
* :func:`classify_error`: the ``Result.error`` labels.
* :func:`serve_with_restarts`: serves through engine crashes: on
  :class:`EngineCrash` it snapshots the dead engine
  (``ContinuousEngine.snapshot``), builds a fresh one and re-admits
  every request in flight through the prefix cache; greedy outputs equal
  an uncrashed run's.  The loop is ``runtime.faults.run_with_restarts``.

Everything here is host-side: no tensor, no engine import (the engine
imports this module).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

import torch

from repro_torch.kernels._build import KernelError
from repro_torch.runtime.faults import (FailureInjector, RestartPolicy,
                                        run_with_restarts)

#: the injectable fault kinds (schedule `kind` field)
FAULT_KINDS = ("reserve", "extend", "dispatch", "draft", "poison", "crash")

#: the Result.status vocabulary — every submitted request terminates
#: with exactly one of these (docs/RELIABILITY.md)
RESULT_STATUSES = ("ok", "cancelled", "timeout", "shed", "failed")


class InjectedFault(RuntimeError):
    """A fault the plane injected on purpose.  ``rid >= 0`` marks a
    poison fault targeting one request (the engine quarantines just that
    request); ``rid == -1`` is an untargeted transient (the engine
    retries the whole dispatch)."""

    def __init__(self, kind: str, *, rid: int = -1, step: int = -1):
        super().__init__(f"[injected] {kind} fault"
                         + (f" targeting rid {rid}" if rid >= 0 else "")
                         + (f" at step {step}" if step >= 0 else ""))
        self.kind = kind
        self.rid = rid
        self.step = step


class EngineCrash(RuntimeError):
    """Simulated process death.  Unlike :class:`InjectedFault` this is
    NOT absorbed by the engine's step watchdog — it propagates out of
    ``step()`` so :func:`serve_with_restarts` (or a real supervisor)
    exercises the snapshot/restore path."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``at`` counts per-kind *invocations* for
    reserve/extend (the Nth allocation call fails) and engine *steps*
    for dispatch/draft/crash.  ``count`` is the firing budget: a
    dispatch fault with ``count=2`` fails two consecutive retries of the
    same step before letting it through.  ``rid`` targets poison faults
    at one request (ignored for other kinds)."""

    kind: str
    at: int = 0
    count: int = 1
    rid: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.count < 1:
            raise ValueError("count must be >= 1")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlane:
    """Deterministic, replayable fault injection for the serving stack.

    Construct from a schedule of :class:`FaultSpec` (or
    :meth:`from_schedule` dicts, or :meth:`random` for seeded chaos),
    hand it to ``ContinuousEngine(..., faults=plane)``.  The engine
    wires the seams; the plane only decides *when* to fire and records
    what it fired (``fired``) so failures are replayable via
    :meth:`to_schedule`.

    A single plane may outlive an engine: after an :class:`EngineCrash`
    the restarted engine re-attaches the same plane and the remaining
    schedule keeps counting from where it was — a crash consumed its
    budget and does not re-fire.
    """

    def __init__(self, schedule: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.schedule = tuple(schedule)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        #: record of every firing (dicts: kind/at/step/rid) — the replay
        #: artifact the chaos suite dumps on failure
        self.fired: list[dict] = []
        #: set by the engine: called with each firing record (emits the
        #: ``fault_injected`` event + counter)
        self.on_fire: Callable[[dict], None] | None = None

        def inj(kinds: tuple[str, ...], expand: bool) -> FailureInjector:
            specs = [s for s in self.schedule if s.kind in kinds]
            if expand:
                # invocation-indexed seams: budget n = the next n calls
                trig = [a for s in specs
                        for a in range(s.at, s.at + s.count)]
                return FailureInjector(tuple(trig), exc=_no_exc)
            triggers = tuple(s.at for s in specs)
            count = max((s.count for s in specs), default=1)
            return FailureInjector(triggers, count=count, exc=_no_exc)

        self._inj_reserve = inj(("reserve",), expand=True)
        self._inj_extend = inj(("extend",), expand=True)
        self._inj_dispatch = inj(("dispatch",), expand=False)
        self._inj_draft = inj(("draft",), expand=False)
        self._inj_crash = inj(("crash",), expand=False)
        self._poison: dict[int, int] = {
            s.rid: s.count for s in self.schedule
            if s.kind == "poison" and s.rid >= 0}
        self._n_reserve = 0
        self._n_extend = 0

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_schedule(cls, schedule: Sequence[dict], *,
                      seed: int = 0) -> "FaultPlane":
        """Rebuild a plane from :meth:`to_schedule` output (or a
        hand-written list of dicts) — the replay path."""
        return cls([FaultSpec(**{k: v for k, v in d.items()
                                 if k in ("kind", "at", "count", "rid")})
                    for d in schedule], seed=seed)

    def to_schedule(self) -> list[dict]:
        """The schedule as JSON-safe dicts; feed to :meth:`from_schedule`
        (with the same seed) to replay this plane exactly."""
        return [s.to_dict() for s in self.schedule]

    @classmethod
    def random(cls, seed: int, *, rids: Sequence[int] = (),
               horizon: int = 32, n_faults: int = 4) -> "FaultPlane":
        """A seeded random schedule for chaos testing: a mix of
        allocation denials, transient dispatch failures, poisoned
        requests, and (sometimes) one crash, all inside ``horizon``
        engine steps.  Same seed -> same schedule."""
        rng = np.random.default_rng(seed)
        specs: list[FaultSpec] = []
        kinds = ["reserve", "extend", "dispatch", "dispatch", "poison",
                 "crash"]
        crashed = False
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "crash":
                if crashed:     # at most one crash per schedule
                    kind = "dispatch"
                else:
                    crashed = True
            at = int(rng.integers(1, max(2, horizon)))
            if kind == "poison" and len(rids):
                rid = int(np.asarray(rids)[int(rng.integers(len(rids)))])
                specs.append(FaultSpec("poison", at=at, rid=rid))
            elif kind in ("reserve", "extend"):
                specs.append(FaultSpec(kind, at=at,
                                       count=int(rng.integers(1, 4))))
            elif kind == "poison":
                specs.append(FaultSpec("dispatch", at=at))
            else:
                specs.append(FaultSpec(kind, at=at))
        return cls(specs, seed=seed)

    # -- firing --------------------------------------------------------------

    def _fire(self, kind: str, **detail) -> None:
        rec = {"kind": kind, **detail}
        self.fired.append(rec)
        if self.on_fire is not None:
            self.on_fire(rec)

    def attach_pool(self, pool) -> None:
        """Wrap ``pool.reserve``/``pool.extend`` with the allocation
        seams.  An injected denial looks exactly like pool exhaustion to
        the caller (``None``/``False`` + a recorded backoff), so every
        existing backoff path — admission retry, lazy-span shrink,
        preemption — is exercised unmodified.  ``extend`` reaches the
        wrapped ``reserve`` internally; the ``extend`` seam exists so a
        schedule can target mid-decode growth without also starving
        admissions."""
        orig_reserve = pool.reserve
        orig_extend = pool.extend

        def reserve(n):
            i = self._n_reserve
            self._n_reserve += 1
            if _fires(self._inj_reserve, i):
                self._fire("reserve", at=i, n=int(n))
                pool.backoffs += 1
                pool._m_backoff.inc()
                return None
            return orig_reserve(n)

        def extend(slot, total_tokens):
            i = self._n_extend
            self._n_extend += 1
            if _fires(self._inj_extend, i):
                self._fire("extend", at=i, slot=int(slot))
                pool.backoffs += 1
                pool._m_backoff.inc()
                return False
            return orig_extend(slot, total_tokens)

        pool.reserve = reserve
        pool.extend = extend

    def before_dispatch(self, kind: str, step: int,
                        rids: Sequence[int]) -> None:
        """Engine seam, called before each chunk, decode and verify step
        with the participating request ids.  Raises
        :class:`InjectedFault` (poison first, then untargeted transients)
        or :class:`EngineCrash`.  Raising *before* the step's model call
        means no host state moved: the engine's retry is a pure re-run
        of the same step."""
        for rid in rids:
            left = self._poison.get(int(rid), 0)
            if left > 0:
                self._poison[int(rid)] = left - 1
                self._fire("poison", step=int(step), rid=int(rid))
                raise InjectedFault("poison", rid=int(rid), step=int(step))
        if _fires(self._inj_crash, step):
            self._fire("crash", step=int(step))
            raise EngineCrash(f"[injected] engine crash at step {step}")
        if _fires(self._inj_dispatch, step):
            self._fire("dispatch", step=int(step), dispatch=kind)
            raise InjectedFault("dispatch", step=int(step))

    def corrupt_drafts(self, step: int, drafts, vocab: int):
        """Draft-provider seam: replace proposed draft tokens with
        seeded garbage at scheduled steps.  Verification rejects the
        garbage, so this costs speculation efficiency, never
        correctness — the chaos suite's token-identity invariant holds
        through it."""
        if not _fires(self._inj_draft, step):
            return drafts
        self._fire("draft", step=int(step))
        bad = np.asarray(drafts).copy()
        if bad.size:
            bad[...] = self._rng.integers(3, max(4, vocab),
                                          size=bad.shape)
        return bad


def _no_exc(trigger: int) -> BaseException:
    return _Fire(trigger)


class _Fire(Exception):
    """Internal control-flow marker for FailureInjector seams that want
    a boolean ("should this call fail?") rather than an exception."""


def _fires(inj: FailureInjector, value: int) -> bool:
    try:
        inj.maybe_fail(int(value))
    except _Fire:
        return True
    return False


# ---------------------------------------------------------------------------
# Lifecycle-guard configuration + error taxonomy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResilienceConfig:
    """Engine lifecycle-guard knobs.  Defaults reproduce the legacy
    behavior exactly (unbounded queue, infinite admission retry, one
    dispatch retry, fixed spec_k), so resilience is opt-in per knob and
    a default config is a behavioral no-op."""

    #: load shedding: submissions beyond this many pending requests get
    #: an immediate terminal ``status="shed"`` Result (None = unbounded)
    max_pending: int | None = None
    #: admission attempts before a request fails terminally
    #: (None = retry forever, the legacy backoff behavior)
    max_admit_retries: int | None = None
    #: engine steps to hold a request after a failed admission; doubles
    #: per consecutive failure (0 = retry every step, legacy)
    admit_backoff_steps: int = 0
    #: consecutive failures of one dispatch kind tolerated before the
    #: participating batch is quarantined
    dispatch_retries: int = 1
    #: adaptive spec_k: halve the live speculation depth when the pool
    #: denies an extend, recover one step of depth per
    #: ``spec_recover_steps`` clean steps
    spec_degrade: bool = False
    spec_recover_steps: int = 8


#: faults of the device or of a kernel: a kernel that did not build or
#: launch (``KernelError``) and a sticky CUDA error, after which every
#: launch in the process fails.  Retrying the step or the engine cannot
#: help, and failing the step's requests would hide the fault, so the
#: step watchdog and ``serve_with_restarts`` let these propagate.
DEVICE_FAULTS: tuple[type[BaseException], ...] = (KernelError,) + tuple(
    c for c in (getattr(torch, "AcceleratorError", None),) if c is not None)


def classify_error(exc: BaseException) -> str:
    """Stable ``Result.error`` labels: injected faults carry their
    kind, resource exhaustion is ``resource`` (``MemoryError``, and the
    card's ``torch.OutOfMemoryError``), pool-invariant breaks are
    ``audit``, anything else its exception type name."""
    if isinstance(exc, InjectedFault):
        return f"injected:{exc.kind}"
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return "resource"
    if type(exc).__name__ == "PoolAuditError":
        return "audit"
    return type(exc).__name__


# ---------------------------------------------------------------------------
# Warm-restart driver
# ---------------------------------------------------------------------------

def serve_with_restarts(make_engine: Callable[[], Any],
                        requests: Sequence[Any], *,
                        policy: RestartPolicy | None = None,
                        sleep: Callable[[float], None] | None = None,
                        max_steps: int = 100_000) -> list:
    """Serve ``requests`` to completion across engine crashes.

    ``make_engine`` builds a fresh engine (same config and params each
    time); the driver submits everything to the first engine and pumps
    ``step()``.  When the engine dies (:class:`EngineCrash` from a fault
    plane, or any genuine escape from ``step()``), the dead engine's
    finished Results are drained, its in-flight work snapshotted
    (``engine.snapshot()``), and a fresh engine restores it: re-admitted
    requests resume through the prefix-cache skip-prefill path, so
    greedy outputs equal an uncrashed run's.  A device fault
    (:data:`DEVICE_FAULTS`) is not restarted: it propagates.  The loop,
    restart budget and backoff come from
    ``runtime.faults.run_with_restarts``; the default policy here has no
    backoff (the restart is in-process).

    Returns one terminal Result per submitted request, in completion
    order.
    """
    results: list = []
    total = len(requests)
    state: dict[str, Any] = {"engine": None, "snap": None}

    def pump(_done: int) -> int:
        eng = state["engine"]
        if eng is None:
            eng = make_engine()
            state["engine"] = eng
            if state["snap"] is not None:
                eng.restore(state["snap"])
                state["snap"] = None
            else:
                for r in requests:
                    eng.submit(r)
        steps = 0
        while len(results) < total:
            eng.step()
            results.extend(eng.drain_results())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serve_with_restarts: no completion after "
                    f"{max_steps} steps ({len(results)}/{total} done)")
        return total

    def on_restart(_done: int, exc: Exception) -> int:
        if isinstance(exc, DEVICE_FAULTS):
            raise exc
        dead, state["engine"] = state["engine"], None
        if dead is not None:
            # results finished in the dying step are already terminal —
            # never lose them to the crash
            results.extend(dead.drain_results())
            state["snap"] = dead.snapshot()
        return len(results)

    run_with_restarts(
        pump, start_step=0, final_step=total,
        policy=policy or RestartPolicy(backoff_s=0.0),
        on_restart=on_restart,
        sleep=sleep or (lambda _s: None))
    return results
