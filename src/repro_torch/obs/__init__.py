"""repro_torch.obs — zero-dependency observability: spans and counters.

Spans (phase-attributed wall time, thread-aware nesting) keep the JAX
package's names (``plan``, ``plan.reorder``, ``plan.tune``, ``plan.probe``,
``plan.build``, ``kernel.spmv``, ``kernel.spmm``); the port's spans carry
``backend="torch"``::

    from repro_torch import obs
    with obs.tracing() as buf:
        ...
    events = buf.flush()

Counters: ``obs.counter(name).inc()`` and ``obs.snapshot()``.
"""
from .spans import (Span, TraceBuffer, install_sink,  # noqa: F401
                    remove_sink, span, tracing)
from .metrics import REGISTRY, Counter, counter, reset, snapshot  # noqa: F401

__all__ = [
    "span", "tracing", "install_sink", "remove_sink", "Span", "TraceBuffer",
    "counter", "snapshot", "reset", "REGISTRY", "Counter",
]
