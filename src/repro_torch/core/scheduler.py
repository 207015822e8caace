"""Schedule exploration and the serving ScheduleCache (paper §5; copy of
``repro.core.scheduler``).

Every candidate (lane arrangement x dataflow x fold x direction) is costed
by ``core.dataflow`` and the paper's priority rule picks the least sum of
squares of the min-normalized (cycles, traffic).  ``ScheduleCache``
memoizes the winner per (M, N, K, precision) for the serving hot path;
``schedule_workload`` and the Pareto helpers are the paper's per-workload
and Fig.-9 analysis.
The realizable-fold filter uses ``tiling.FOLD_GRAIN`` (128, the same K
granularity as the reference's MXU_DIM), so the port's cache makes the
same (dataflow, k_fold) choice as the reference's for every shape.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from collections.abc import Sequence

from repro_torch.core.dataflow import (ArrayShape, CostReport, Dataflow,
                                       Direction, candidate_costs)
from repro_torch.core.pgemm import PGEMM
from repro_torch.core.precision import BY_NAME, Precision
from repro_torch.core.tiling import FOLD_GRAIN
from repro_torch.obs.metrics import NULL_METRIC

MPRA_DIM = 8  # each lane carries one 8x8 MPRA (paper §4.1)


@dataclasses.dataclass(frozen=True)
class GTAConfig:
    """Physical configuration of a GTA instance (lanes of 8x8 MPRAs; one
    systolic mask group spans at most ``max_group_lanes`` lanes)."""

    lanes: int = 4
    mpra_dim: int = MPRA_DIM
    max_group_lanes: int = 64

    @property
    def total_pes(self) -> int:
        return self.lanes * self.mpra_dim * self.mpra_dim

    @property
    def group_lanes(self) -> int:
        return min(self.lanes, self.max_group_lanes)

    @property
    def groups(self) -> int:
        """Mask groups run data-parallel when the lanes exceed one group
        (§4.2)."""
        return max(1, self.lanes // self.group_lanes)

    def arrangements(self) -> list[ArrayShape]:
        """All (rows x cols) arrays reachable by re-arranging the lanes of
        one mask group."""
        n = self.group_lanes
        return [ArrayShape(r * self.mpra_dim, (n // r) * self.mpra_dim)
                for r in range(1, n + 1) if n % r == 0]


@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """The selected schedule plus the whole explored space."""

    best: CostReport
    space: tuple[CostReport, ...]

    @property
    def cycles(self) -> float:
        return self.best.cycles

    @property
    def traffic_bytes(self) -> float:
        return self.best.traffic_bytes


def sum_of_squares_priority(reports: Sequence[CostReport]) -> CostReport:
    """Paper §5: normalize each metric to its minimum over the candidates
    and pick the least sum of squares."""
    if not reports:
        raise ValueError("no candidate schedules")
    min_c = max(min(r.cycles for r in reports), 1e-9)
    min_t = max(min(r.traffic_bytes for r in reports), 1e-9)
    return min(reports, key=lambda r: (r.cycles / min_c) ** 2
               + (r.traffic_bytes / min_t) ** 2)


def explore(op: PGEMM, config: GTAConfig,
            k_folds: list[int] | None = None) -> ScheduleChoice:
    """Enumerate (arrangement x dataflow x fold x direction) and select."""
    space: list[CostReport] = []
    for array in config.arrangements():
        space.extend(candidate_costs(op, array, k_folds=k_folds))
    return ScheduleChoice(best=sum_of_squares_priority(space),
                          space=tuple(space))


def schedule_workload(ops: Sequence[PGEMM], config: GTAConfig
                      ) -> list[ScheduleChoice]:
    """Schedule every p-GEMM of a workload independently (the paper
    schedules per operator)."""
    return [explore(op, config) for op in ops]


GemmKey = tuple[int, int, int, str]  # (M, N, K, precision name)


@dataclasses.dataclass(frozen=True)
class CachedChoice:
    """The memoized winner of one ``explore`` run."""

    dataflow: Dataflow
    array: ArrayShape
    k_fold: int
    direction: Direction
    cycles: float
    traffic_bytes: float


class ScheduleCache:
    """Shape -> schedule memo consulted on the serving hot path.

    ``resolve`` explores once per distinct (M, N, K, precision) and is a
    dict hit afterwards; ``kernels.ops.matmul`` applies the choice to the
    mpgemm launch and records what executed with :meth:`note_applied`.
    Thread-safe."""

    def __init__(self, config: GTAConfig | None = None,
                 k_folds: list[int] | None = None):
        self.config = config or GTAConfig()
        self.k_folds = k_folds
        self._entries: dict[GemmKey, CachedChoice] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        #: per-key [hits, misses]: which shape paid the exploration
        self._key_stats: dict[GemmKey, list[int]] = {}
        #: bounded tail of (key, CachedChoice) kernel applications
        self.applied: collections.deque[tuple[GemmKey, CachedChoice]] = (
            collections.deque(maxlen=1024))
        self.applied_total = 0
        self._m_hits = self._m_misses = self._m_applied = NULL_METRIC

    def bind_metrics(self, registry) -> None:
        """Mirror hit/miss/applied events into ``schedule.*`` counters."""
        self._m_hits = registry.counter(
            "schedule.hits", "ScheduleCache memo hits since bind")
        self._m_misses = registry.counter(
            "schedule.misses", "ScheduleCache explorations since bind")
        self._m_applied = registry.counter(
            "schedule.applied", "kernel applications since bind")

    @staticmethod
    def key_of(M: int, N: int, K: int,
               precision: Precision | str) -> GemmKey:
        name = precision if isinstance(precision, str) else precision.name
        return (int(M), int(N), int(K), name)

    def realizable_k_folds(self, K: int) -> list[int]:
        """Fold candidates the kernel can execute for this contraction:
        the divisors of ``ceil(K / FOLD_GRAIN)`` among the candidates."""
        gk = max(1, -(-int(K) // FOLD_GRAIN))
        cands = self.k_folds or [1, 2, 4, 8]
        folds = [f for f in cands if f <= gk and gk % f == 0]
        return folds or [1]

    def resolve(self, M: int, N: int, K: int,
                precision: Precision | str) -> CachedChoice:
        key = self.key_of(M, N, K, precision)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                self._key_stats.setdefault(key, [0, 0])[0] += 1
                self._m_hits.inc()
                return hit
        entry = self._explore(key, "serve")
        with self._lock:
            self.misses += 1
            self._key_stats.setdefault(key, [0, 0])[1] += 1
            self._m_misses.inc()
            self._entries.setdefault(key, entry)
            return self._entries[key]

    def modeled_cycles(self, M: int, N: int, K: int,
                       precision: Precision | str) -> CachedChoice:
        """The entry ``resolve`` would return, WITHOUT moving the
        aggregate or per-key hit/miss statistics: the planner's read
        path.  An unseen shape is explored and memoized once."""
        key = self.key_of(M, N, K, precision)
        with self._lock:
            hit = self._entries.get(key)
        if hit is not None:
            return hit
        entry = self._explore(key, "plan")
        with self._lock:
            self._entries.setdefault(key, entry)
            return self._entries[key]

    def _explore(self, key: GemmKey, name: str) -> CachedChoice:
        op = PGEMM(name, M=key[0], N=key[1], K=key[2],
                   precision=BY_NAME[key[3]])
        choice = explore(op, self.config, self.realizable_k_folds(key[2]))
        sched = choice.best.schedule
        return CachedChoice(dataflow=sched.dataflow, array=sched.array,
                            k_fold=sched.k_fold, direction=sched.direction,
                            cycles=choice.best.cycles,
                            traffic_bytes=choice.best.traffic_bytes)

    def insert(self, M: int, N: int, K: int, precision: Precision | str,
               choice: CachedChoice) -> None:
        """Force an entry (tests / offline-tuned overrides)."""
        with self._lock:
            self._entries[self.key_of(M, N, K, precision)] = choice

    def note_applied(self, M: int, N: int, K: int,
                     precision: Precision | str,
                     choice: CachedChoice, *,
                     effective_k_fold: int | None = None,
                     effective_dataflow: Dataflow | None = None) -> None:
        """Record one kernel application of ``choice`` as it EXECUTED
        (the effective fold and dataflow, not the request)."""
        if effective_k_fold is not None and effective_k_fold != choice.k_fold:
            choice = dataclasses.replace(choice, k_fold=effective_k_fold)
        if (effective_dataflow is not None
                and effective_dataflow is not choice.dataflow):
            choice = dataclasses.replace(choice, dataflow=effective_dataflow)
        with self._lock:
            self.applied.append((self.key_of(M, N, K, precision), choice))
            self.applied_total += 1
            self._m_applied.inc()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries),
                    "applied": self.applied_total}

    def key_stats(self) -> dict[GemmKey, dict[str, int]]:
        """Per-shape hit/miss breakdown."""
        with self._lock:
            return {k: {"hits": v[0], "misses": v[1]}
                    for k, v in self._key_stats.items()}

    def reset(self) -> None:
        """Zero the hit/miss counters, aggregate and per key, without
        dropping entries or the applied log (call after warmup; a later
        miss is a new shape)."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self._key_stats.clear()

    def fork(self) -> ScheduleCache:
        """A cache holding this one's entries, with fresh counters and an
        empty applied log (what a pricing run resolves through, so this
        cache's statistics stay as they are)."""
        out = ScheduleCache(self.config, self.k_folds)
        with self._lock:
            out._entries = dict(self._entries)
        return out

    def summary(self) -> list[tuple[GemmKey, CachedChoice]]:
        """Entries sorted by modeled cycles, heaviest first."""
        with self._lock:
            return sorted(self._entries.items(),
                          key=lambda kv: -kv[1].cycles)


# ---------------------------------------------------------------------------
# Pareto utilities (Fig. 9 analysis)
# ---------------------------------------------------------------------------

def pareto_front(reports: Sequence[CostReport]) -> list[CostReport]:
    """Non-dominated (cycles, traffic) points, ascending by cycles."""
    pts = sorted(reports, key=lambda r: (r.cycles, r.traffic_bytes))
    front: list[CostReport] = []
    best_t = math.inf
    for r in pts:
        if r.traffic_bytes < best_t:
            front.append(r)
            best_t = r.traffic_bytes
    return front


def is_on_or_dominated_boundary(choice: CostReport,
                                reports: Sequence[CostReport]) -> bool:
    """True iff no candidate strictly dominates ``choice`` in both
    metrics (the sum-of-squares pick never is dominated)."""
    return not any(r.cycles < choice.cycles
                   and r.traffic_bytes < choice.traffic_bytes
                   for r in reports)
