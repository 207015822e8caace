"""Metrics registry (copy of the part of ``repro.obs.metrics`` that the
KV pool, the schedule cache and the engine record into: counters and
gauges).

Recording is a plain attribute update on the host; nothing here touches
a tensor.  ``MetricsRegistry(enabled=False)`` hands out the shared
:data:`NULL_METRIC`, whose record methods do nothing.
"""

from __future__ import annotations

import threading


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
    """Last-value gauge."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str = "", help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _Null:
    """Shared no-op metric."""

    __slots__ = ()
    kind = "null"
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass


#: the shared null metric every disabled-registry request returns
NULL_METRIC = _Null()


class MetricsRegistry:
    """Name -> metric store with get-or-create registration."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str):  # noqa: A002
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help)
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
