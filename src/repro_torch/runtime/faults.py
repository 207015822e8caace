"""Fault-tolerance logic: heartbeats, straggler policy, the restart
driver (a copy of ``repro.runtime.faults``).

The failure model of a large cluster: hosts disappear (preemption, a
hardware fault), hosts straggle (thermal, network), and the job must
make progress with bounded lost work.  This module detects (heartbeats),
decides (``HeartbeatMonitor.decision``, ``plan_elastic_mesh``) and
restarts (``run_with_restarts`` under a ``RestartPolicy``).  It is pure
logic and wall clock, testable in one process.  Serving uses
``FailureInjector``, ``RestartPolicy`` and ``run_with_restarts``
(``serving.resilience``); ``HeartbeatMonitor`` and ``plan_elastic_mesh``
have no multi-host user in the port yet.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections.abc import Callable


class HostState(enum.Enum):
    HEALTHY = "healthy"
    STRAGGLING = "straggling"
    DEAD = "dead"


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    straggler_factor: float = 3.0   # x median step time => straggling
    dead_after_s: float = 60.0
    min_healthy_fraction: float = 0.9  # below this => shrink & restart


class HeartbeatMonitor:
    """Tracks per-host liveness + step latency; classifies hosts."""

    def __init__(self, n_hosts: int, cfg: HeartbeatConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or HeartbeatConfig()
        self.clock = clock
        self.last_seen: dict[int, float] = {h: clock() for h in range(n_hosts)}
        self.step_times: dict[int, float] = {}

    def beat(self, host: int, step_time_s: float | None = None):
        self.last_seen[host] = self.clock()
        if step_time_s is not None:
            self.step_times[host] = step_time_s

    def classify(self) -> dict[int, HostState]:
        now = self.clock()
        med = (sorted(self.step_times.values())[len(self.step_times) // 2]
               if self.step_times else None)
        out = {}
        for h, seen in self.last_seen.items():
            if now - seen > self.cfg.dead_after_s:
                out[h] = HostState.DEAD
            elif (med is not None and h in self.step_times
                  and self.step_times[h] > self.cfg.straggler_factor * med):
                out[h] = HostState.STRAGGLING
            else:
                out[h] = HostState.HEALTHY
        return out

    def decision(self) -> str:
        """'ok' | 'mitigate' (stragglers present) | 'restart' (hosts lost)."""
        states = self.classify()
        dead = sum(1 for s in states.values() if s is HostState.DEAD)
        strag = sum(1 for s in states.values() if s is HostState.STRAGGLING)
        healthy_frac = 1 - dead / max(1, len(states))
        # any dead host already forces healthy_frac < 1.0, so a single
        # threshold test covers both "hosts lost" and "too few healthy"
        if dead or healthy_frac < self.cfg.min_healthy_fraction:
            return "restart"
        if strag:
            return "mitigate"
        return "ok"


# ---------------------------------------------------------------------------
# Elastic mesh planning
# ---------------------------------------------------------------------------

def plan_elastic_mesh(n_chips: int, model_parallel: int
                      ) -> tuple[int, int]:
    """Largest (data, model) grid fitting the surviving chips: model
    parallelism is fixed by the architecture (must divide weights), the data
    axis absorbs the shrink.  Returns (data, model); chips beyond
    data*model idle until the next resize."""
    if n_chips < model_parallel:
        raise ValueError(f"{n_chips} chips cannot host model_parallel="
                         f"{model_parallel}")
    data = n_chips // model_parallel
    return data, model_parallel


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 100
    #: base restart delay; doubles per consecutive restart up to
    #: ``backoff_max_s``, with ``jitter`` fractional randomization so a
    #: fleet of restarting replicas does not thundering-herd the
    #: checkpoint store.  Zero disables the wait entirely (tests).
    backoff_s: float = 5.0
    backoff_max_s: float = 60.0
    jitter: float = 0.1

    def delay_s(self, restarts: int, u: float = 0.0) -> float:
        """Delay before restart number ``restarts`` (1-based), given a
        uniform sample ``u`` in [0, 1) for the jitter term."""
        if self.backoff_s <= 0.0:
            return 0.0
        base = min(self.backoff_s * 2.0 ** (restarts - 1),
                   self.backoff_max_s)
        return base * (1.0 + self.jitter * u)


class FailureInjector:
    """Deterministic failure schedule for tests/drills: raises when
    ``maybe_fail`` sees a configured trigger value (simulating a lost
    collective / dead host / poisoned dispatch).

    Each trigger fires at most ``count`` times (default once) — serving
    needs ``count`` because a failed dispatch does not advance the
    engine's step index, so a step-keyed fault with ``count=n`` means
    "fail n consecutive retries, then let it through".  ``exc`` swaps
    the raised exception type (``exc(trigger) -> BaseException``); the
    serving fault plane uses it to raise its typed faults through the
    same schedule machinery."""

    def __init__(self, fail_at_steps: tuple[int, ...] = (), *,
                 count: int = 1,
                 exc: Callable[[int], BaseException] | None = None):
        self.fail_at = set(fail_at_steps)
        self.fired = set()          # triggers whose budget is exhausted
        self._exc = exc
        self._budget = {s: count for s in self.fail_at}

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self._budget[step] -= 1
            if self._budget[step] <= 0:
                self.fired.add(step)
            if self._exc is not None:
                raise self._exc(step)
            raise RuntimeError(f"[injected] host failure at step {step}")


def run_with_restarts(train_loop: Callable[[int], int], *,
                      start_step: int,
                      final_step: int,
                      policy: RestartPolicy | None = None,
                      on_restart: Callable[[int, Exception], int] | None
                      = None,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Callable[[], float] | None = None) -> int:
    """Drives ``train_loop(start) -> reached_step`` under the restart policy.
    ``on_restart(step, exc) -> resume_step`` typically restores the latest
    checkpoint and returns its step.  Between restarts the driver backs
    off exponentially with jitter (``RestartPolicy.delay_s``) through the
    injectable ``sleep`` — pass a zero-backoff policy or a recording
    ``sleep`` in tests to stay instant.  Returns the final step reached."""
    policy = policy or RestartPolicy()
    step = start_step
    restarts = 0
    while step < final_step:
        try:
            step = train_loop(step)
        except Exception as exc:  # noqa: BLE001 — any host loss surfaces here
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            if on_restart is not None:
                step = on_restart(step, exc)
            delay = policy.delay_s(restarts, rng() if rng else 0.0)
            if delay > 0.0:
                sleep(delay)
    return step
