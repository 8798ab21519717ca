"""Process-wide metrics: counters, gauges, histograms, read together by
``snapshot()``.

One registry per process (module-level ``REGISTRY``); metrics are
get-or-created by ``(name, labels)`` so every layer that counts the same
thing increments the same object:

    reorder_cache.hits / .misses            core/reorder/api.py
    delta.applies / .fallbacks              core/spmv/delta.py
    service.*{service=...}                  serving/spmv_service.py
    workload.*                              workloads/dynamic.py

Metric objects have their own small lock, but callers holding a coarser
lock (the service's condition variable) keep their snapshot atomicity:
every service counter is mutated under ``_cv``, so a ``stats()`` read
under ``_cv`` sees one consistent cut.

Kernel launch counts are plain integers beside the kernels
(``repro_torch.kernels.LAUNCHES``), not metrics: they are read around one
run to show which kernels it went through.
"""
from __future__ import annotations

import threading


def _fmt(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic-by-convention numeric counter (set() exists for views)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._v += n

    def set(self, v):
        with self._lock:
            self._v = v

    @property
    def value(self):
        return self._v


class Gauge:
    """Point-in-time value, with a max-tracking helper."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self._v = v

    def max(self, v):
        with self._lock:
            if v > self._v:
                self._v = v

    @property
    def value(self):
        return self._v


class Histogram:
    """Streaming count/sum/min/max (enough for avg + extremes)."""

    __slots__ = ("count", "sum", "min", "max", "_lock")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def summary(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max,
                    "avg": (self.sum / self.count) if self.count else None}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def _get(self, table: dict, cls, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        m = table.get(key)
        if m is None:
            with self._lock:
                m = table.setdefault(key, cls())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def total(self, name: str) -> float:
        """Sum of one counter name across all label sets."""
        return sum(c.value for (n, _), c in list(self._counters.items())
                   if n == name)

    def snapshot(self) -> dict:
        """All metrics as plain data: {'counters': {...}, ...}."""
        return {
            "counters": {_fmt(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {_fmt(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {_fmt(k): h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    def reset(self) -> None:
        """Drop every metric (tests only — live handles are invalidated)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
