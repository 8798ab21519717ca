"""Nested, thread-aware spans with a near-zero disabled path.

``span(name, **attrs)`` returns a context manager. With no sink
installed (the default) it returns one shared singleton whose
``__enter__``/``__exit__`` do nothing — a single module-global flag
test, no lock, no allocation — so instrumentation can stay on in hot
paths (per-request dispatch, operator ``__call__``).

With a sink installed (``install_sink`` / the ``tracing()``
contextmanager) spans record wall time via ``perf_counter_ns``, nest
through a thread-local stack (each thread owns its own span tree) and
are exception-safe:

* a span exited by an unwinding exception still records, with an
  ``error`` attribute naming the exception type;
* a child span that was entered but never exited (e.g. a probe that
  raised between ``__enter__`` and manual bookkeeping) is force-closed
  when its enclosing span exits, tagged ``unclosed``.

Timestamps are microseconds on the ``perf_counter_ns`` clock — an
arbitrary but monotonic origin, which is all the Chrome-trace/Perfetto
format needs. ``TraceBuffer.flush()`` returns events in a deterministic
order (ts, tid, id) regardless of which thread emitted first.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager

_PID = os.getpid()
_sinks: list = []          # sink objects with an .add(event: dict) method
_enabled = False           # fast-path flag, kept in sync with _sinks
_ids = itertools.count(1)  # CPython-atomic span id source
_tls = threading.local()


class _NullSpan:
    """Shared no-op span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class Span:
    """A live span (tracing enabled). Use as a context manager."""

    __slots__ = ("name", "attrs", "id", "parent", "tid", "thread",
                 "t0", "_open")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent = None
        self.tid = 0
        self.thread = ""
        self.t0 = 0
        self._open = False

    def set(self, **attrs):
        """Attach attributes after entry (e.g. a result computed inside)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread = t.name
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._open = True
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, etype, evalue, tb):
        t1 = time.perf_counter_ns()
        stack = getattr(_tls, "stack", None) or []
        # Force-close any descendants left open by a raise between their
        # __enter__ and __exit__ (they sit above us on the stack).
        while stack and stack[-1] is not self:
            dangling = stack.pop()
            dangling._open = False
            _emit(dangling, t1, unclosed=True)
        if stack and stack[-1] is self:
            stack.pop()
        self._open = False
        _emit(self, t1, error=etype.__name__ if etype else None)
        return False


def _emit(span: Span, t1_ns: int, error=None, unclosed=False) -> None:
    attrs = span.attrs
    if error:
        attrs = dict(attrs, error=error)
    if unclosed:
        attrs = dict(attrs, unclosed=True)
    ev = {
        "name": span.name,
        "ts": span.t0 / 1e3,          # µs, perf_counter origin
        "dur": (t1_ns - span.t0) / 1e3,
        "pid": _PID,
        "tid": span.tid,
        "thread": span.thread,
        "id": span.id,
        "parent": span.parent,
        "args": attrs,
    }
    for sink in list(_sinks):
        sink.add(ev)


def span(name: str, **attrs):
    """Open a span. Near-free when no sink is installed."""
    if not _enabled:
        return _NULL
    return Span(name, attrs)


def enabled() -> bool:
    return _enabled


class TraceBuffer:
    """The default sink: collects events; flush() orders deterministically."""

    def __init__(self):
        self._events: list = []
        self._lock = threading.Lock()

    def add(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def flush(self) -> list:
        """Events sorted by (ts, tid, id) — stable across thread races."""
        with self._lock:
            evs = list(self._events)
        return sorted(evs, key=lambda e: (e["ts"], e["tid"], e["id"]))


def install_sink(sink) -> None:
    global _enabled
    if sink not in _sinks:
        _sinks.append(sink)
    _enabled = True


def remove_sink(sink) -> None:
    global _enabled
    try:
        _sinks.remove(sink)
    except ValueError:
        pass
    _enabled = bool(_sinks)


@contextmanager
def tracing(buffer: TraceBuffer = None):
    """Enable tracing for a scope; yields the TraceBuffer."""
    buf = buffer if buffer is not None else TraceBuffer()
    install_sink(buf)
    try:
        yield buf
    finally:
        remove_sink(buf)
