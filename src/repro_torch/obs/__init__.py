"""Telemetry of the serving stack: the metrics registry, the lifecycle
tracer and the dispatch profiler (a port of ``repro.obs``).

One :class:`Telemetry` bundle threads through the engine
(``ContinuousEngine(telemetry=...)``):

  * ``metrics``: a :class:`~repro_torch.obs.metrics.MetricsRegistry`.
    The engine always records into a real registry: its counters back
    ``engine.steps`` and the other counter properties, so they read the
    same whether or not telemetry was asked for.
  * ``tracer``: a :class:`~repro_torch.obs.events.Tracer`, disabled by
    default (``Telemetry.off()``): the ring records nothing and the hot
    paths skip packing an event behind ``tracer.enabled``.
  * ``profiler``: an optional
    :class:`~repro_torch.obs.profile.DispatchProfiler`, ``None`` by
    default (it syncs after every dispatch, so it is opt-in).

``Telemetry.on()`` enables tracing (``profile=True`` adds the profiler);
the exporters write the Chrome trace and the metrics snapshot wherever
``--trace-out`` / ``--metrics-out`` point.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.events import Event, Tracer, validate_chrome_trace
from repro_torch.obs.metrics import (NULL_METRIC, NULL_REGISTRY, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     Series)
from repro_torch.obs.profile import DISPATCH_NAMES, DispatchProfiler

__all__ = [
    "Counter", "Gauge", "Histogram", "Series", "MetricsRegistry",
    "NULL_METRIC", "NULL_REGISTRY", "Event", "Tracer",
    "validate_chrome_trace", "DispatchProfiler", "DISPATCH_NAMES",
    "Telemetry", "render_report",
]


@dataclasses.dataclass
class Telemetry:
    """The telemetry bundle an engine serves under (see module doc)."""

    metrics: MetricsRegistry = None  # type: ignore[assignment]
    tracer: Tracer = None            # type: ignore[assignment]
    profiler: DispatchProfiler | None = None

    def __post_init__(self):
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        if self.tracer is None:
            self.tracer = Tracer(enabled=False)

    @classmethod
    def off(cls) -> "Telemetry":
        """Engine default: registry-backed counters, no tracing ring, no
        profiler."""
        return cls()

    @classmethod
    def on(cls, *, profile: bool = False, capacity: int = 65536,
           reps: int = 3) -> "Telemetry":
        """Tracing and metrics enabled; ``profile=True`` adds the
        dispatch profiler (a sync after every dispatch, ``reps`` timed
        calibration calls of each)."""
        return cls(tracer=Tracer(capacity=capacity, enabled=True),
                   profiler=DispatchProfiler(reps=reps) if profile
                   else None)

    # -- exporters ------------------------------------------------------------

    def export_trace(self, path: str) -> None:
        self.tracer.export(path)

    def export_metrics(self, path: str) -> None:
        self.metrics.export(path)


def render_report(metrics: MetricsRegistry, *, wall_s: float = 0.0
                  ) -> str:
    """End-of-run serving report read back from the registry alone, by
    public metric names (``launch/serve.py`` prints it)."""
    v = metrics.value
    lines = ["-- serving report (metrics registry) --"]
    finished = v("engine.requests_finished")
    tokens = v("engine.tokens_emitted")
    if wall_s > 0:
        lines.append(f"  throughput        {tokens / wall_s:8.1f} tok/s"
                     f"  ({int(finished)} requests, {wall_s:.2f}s)")
    else:
        lines.append(f"  requests finished {int(finished):8d}"
                     f"  ({int(tokens)} tokens)")
    lines.append(f"  engine steps      {int(v('engine.steps')):8d}"
                 f"  (+{int(v('engine.chunk_steps'))} chunk batches, "
                 f"{int(v('engine.prefills'))} prefills)")
    h = metrics.get("engine.ttft_steps")
    if h is not None and h.count:
        lines.append(f"  ttft steps        p50 {h.percentile(50):6.0f}"
                     f"   p95 {h.percentile(95):6.0f}")
    hl = metrics.get("engine.request_latency_s")
    if hl is not None and hl.count:
        lines.append(f"  latency (s)       p50 {hl.percentile(50):6.3f}"
                     f"   p95 {hl.percentile(95):6.3f}")
    samples = v("engine.pool_util_samples")
    if samples:
        util = v("engine.pool_util_sum") / samples
        lines.append(f"  pool util (mean)  {util:8.3f}")
    lines.append(f"  admissions        {int(v('engine.admissions')):8d}"
                 f"  (resumes {int(v('engine.resumes'))}, preemptions "
                 f"{int(v('engine.preemptions'))})")
    verifies = v("spec.slot_verifies")
    if verifies:
        acc = v("spec.tokens_emitted") / verifies
        lines.append(f"  spec acceptance   {acc:8.2f} tok/verify"
                     f"  (drafted {int(v('spec.drafted'))}, accepted "
                     f"{int(v('spec.accepted'))})")
    hits, misses = v("schedule.hits"), v("schedule.misses")
    if hits or misses:
        rate = hits / max(hits + misses, 1)
        lines.append(f"  schedule cache    {rate:8.3f} hit rate"
                     f"  ({int(hits)} hits / {int(misses)} misses)")
    if v("kv_pool.evictions") or v("kv_pool.shared_token_hits"):
        lines.append(
            f"  kv pool           shared-token hits "
            f"{int(v('kv_pool.shared_token_hits'))}, evictions "
            f"{int(v('kv_pool.evictions'))}, cow forks "
            f"{int(v('kv_pool.cow_forks'))}")
    return "\n".join(lines)
