"""Process-wide counters, read together by ``snapshot()``.

One registry per process (module-level ``REGISTRY``); counters are
get-or-created by ``(name, labels)`` so every layer that counts the same
thing increments the same object:

    reorder_cache.hits / .misses            core/reorder/api.py

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
    """Monotonic numeric counter."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}

    def counter(self, name: str, **labels) -> Counter:
        key = (name, tuple(sorted(labels.items())))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def total(self, name: str) -> float:
        """Sum of one counter name across all label sets."""
        return sum(c.value for (n, _), c in list(self._counters.items())
                   if n == name)

    def snapshot(self) -> dict:
        """All counters as plain data: {'counters': {name: value}}."""
        return {"counters": {_fmt(k): c.value
                             for k, c in sorted(self._counters.items())}}

    def reset(self) -> None:
        """Drop every counter (tests only — live handles are invalidated)."""
        with self._lock:
            self._counters.clear()


REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
