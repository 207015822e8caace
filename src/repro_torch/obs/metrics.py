"""Metrics registry: named counters, gauges, histograms and series (a
copy of ``repro.obs.metrics``).

One registry collects every serving-stack metric under a dotted name
(``engine.steps``, ``kv_pool.evictions``, ``schedule.hits``,
``resilience.retries``; the catalog is ``docs/OBSERVABILITY.md``).

  * **Recording is an attribute update on the host.**  ``Counter.inc``,
    ``Gauge.set``, ``Histogram.observe`` and ``Series.append`` never
    touch a tensor: callers record host numbers only.
  * **A disabled registry records nothing.**
    ``MetricsRegistry(enabled=False)`` hands out the shared
    :data:`NULL_METRIC`, whose record methods do nothing, and its
    ``snapshot()`` is ``{}``.
  * **Exporters are views.**  ``snapshot()`` is a pure-JSON dict;
    ``to_prometheus()`` renders the Prometheus text format (counters and
    gauges as they are, histograms as cumulative ``_bucket`` / ``_sum``
    / ``_count``, series as a ``_total`` counter).

Metric creation takes the registry lock; recording relies on the GIL
(one attribute update), so the serve loop's thread and its callers may
both record.
"""

from __future__ import annotations

import collections
import json
import threading

#: default histogram bucket upper bounds (generic latency/step scale)
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

#: bounded raw-sample reservoir per histogram (exact percentiles for the
#: serving report; Prometheus buckets carry the unbounded aggregate)
SAMPLE_CAP = 4096

#: default bound of a Series ring
SERIES_CAP = 65536


class Counter:
    """Monotone float counter (``inc`` only)."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value gauge (``set``/``inc``)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Bucketed histogram plus a bounded exact-sample reservoir.

    ``observe`` updates the cumulative aggregates (count/sum/buckets,
    never bounded) and appends to a bounded sample deque used by
    :meth:`percentile` — exact over the most recent ``SAMPLE_CAP``
    observations, which is what the end-of-run serving report wants.
    """

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "samples")
    kind = "histogram"

    def __init__(self, name: str = "", help: str = "",  # noqa: A002
                 buckets: tuple | None = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)    # +1: +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.samples: collections.deque = collections.deque(
            maxlen=SAMPLE_CAP)

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self.samples.append(v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (0..100) of the sample reservoir."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]


class Series:
    """Bounded append-only value ring (timestamps, durations);
    ``values`` is the deque itself."""

    __slots__ = ("name", "help", "values", "total")
    kind = "series"

    def __init__(self, name: str = "", help: str = "",  # noqa: A002
                 maxlen: int = SERIES_CAP):
        self.name = name
        self.help = help
        self.values: collections.deque = collections.deque(maxlen=maxlen)
        self.total = 0

    def append(self, v: float) -> None:
        self.values.append(v)
        self.total += 1

    def __len__(self) -> int:
        return len(self.values)


class _Null:
    """Shared no-op metric: every record method is a single pass."""

    __slots__ = ()
    name = ""
    help = ""
    kind = "null"
    value = 0.0
    sum = 0.0
    count = 0
    total = 0
    buckets = ()
    counts = ()
    samples: collections.deque = collections.deque(maxlen=1)
    values: collections.deque = collections.deque(maxlen=1)

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def append(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def __len__(self) -> int:
        return 0


#: the shared null metric every disabled-registry request returns
NULL_METRIC = _Null()


def _prom_name(name: str) -> str:
    """Dotted metric name -> Prometheus-legal name."""
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if not out[:1].isdigit() else f"_{out}"


class MetricsRegistry:
    """Name -> metric store with get-or-create registration.

    ``enabled=False`` is the no-op fast path: every ``counter`` /
    ``gauge`` / ``histogram`` / ``series`` call returns the shared
    :data:`NULL_METRIC` and ``snapshot()`` is ``{}``.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: "collections.OrderedDict[str, object]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()

    # -- registration --------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str, **kw):  # noqa: A002
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  buckets: tuple | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def series(self, name: str, help: str = "",  # noqa: A002
               maxlen: int = SERIES_CAP) -> Series:
        return self._get_or_create(Series, name, help, maxlen=maxlen)

    def get(self, name: str):
        """The registered metric, or None."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar value of a counter/gauge by name (0 if absent)."""
        m = self.get(name)
        return float(m.value) if m is not None and hasattr(m, "value") \
            else default

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Pure-JSON state dump: ``{}`` when disabled.

        Shape: ``{"counters": {name: value}, "gauges": {...},
        "histograms": {name: {count, sum, p50, p95, p99, buckets}},
        "series": {name: {count, total, last}}}``.
        """
        if not self.enabled:
            return {}
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "series": {}}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if m.kind == "counter":
                out["counters"][name] = m.value
            elif m.kind == "gauge":
                out["gauges"][name] = m.value
            elif m.kind == "histogram":
                buckets = {str(ub): c
                           for ub, c in zip(m.buckets, m.counts)}
                buckets["+Inf"] = m.counts[-1]
                out["histograms"][name] = {
                    "count": m.count, "sum": m.sum,
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "p99": m.percentile(99), "buckets": buckets}
            elif m.kind == "series":
                vals = m.values
                out["series"][name] = {
                    "count": len(vals), "total": m.total,
                    "last": float(vals[-1]) if vals else 0.0}
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: list[str] = []
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if m.kind in ("counter", "gauge"):
                lines.append(f"# TYPE {pn} {m.kind}")
                lines.append(f"{pn} {m.value:g}")
            elif m.kind == "histogram":
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                for ub, c in zip(m.buckets, m.counts):
                    cum += c
                    lines.append(f'{pn}_bucket{{le="{ub:g}"}} {cum}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pn}_sum {m.sum:g}")
                lines.append(f"{pn}_count {m.count}")
            elif m.kind == "series":
                # no native Prometheus series type: expose the running
                # total as a counter so scrapes see the event rate
                lines.append(f"# TYPE {pn}_total counter")
                lines.append(f"{pn}_total {m.total}")
        return "\n".join(lines) + "\n"

    def export(self, path: str) -> None:
        """Write the JSON snapshot (``.prom`` suffix: Prometheus text)."""
        with open(path, "w") as f:
            if path.endswith(".prom"):
                f.write(self.to_prometheus())
            else:
                f.write(self.to_json(indent=2))
                f.write("\n")


#: shared always-disabled registry (callers that want "no metrics")
NULL_REGISTRY = MetricsRegistry(enabled=False)
