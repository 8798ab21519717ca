"""repro_torch.obs — zero-dependency observability: spans and counters.

Spans (phase-attributed wall time, thread-aware nesting) keep the JAX
package's names (``plan``, ``plan.reorder``, ``plan.tune``, ``plan.probe``,
``plan.build``, ``kernel.spmv``, ``kernel.spmm``); the port's spans carry
``backend="torch"``::

    from repro_torch import obs
    with obs.tracing() as buf:
        ...
    events = buf.flush()

Counters: ``obs.counter(name).inc()`` and ``obs.snapshot()``. Exporters:
``obs.write_trace("trace.json", events)`` writes Chrome-trace JSON (load it
in Perfetto), ``validate_chrome_trace`` checks one.
"""
from .spans import (Span, TraceBuffer, install_sink,  # noqa: F401
                    remove_sink, span, tracing)
from .metrics import REGISTRY, Counter, counter, reset, snapshot  # noqa: F401
from .export import (to_chrome_trace, validate_chrome_trace,  # noqa: F401
                     write_chrome_trace, write_jsonl, write_trace)

__all__ = [
    "span", "tracing", "install_sink", "remove_sink", "Span", "TraceBuffer",
    "counter", "snapshot", "reset", "REGISTRY", "Counter",
    "to_chrome_trace", "write_chrome_trace", "write_jsonl", "write_trace",
    "validate_chrome_trace",
]
