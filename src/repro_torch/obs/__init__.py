"""repro_torch.obs — zero-dependency observability: spans and counters.

Spans (phase-attributed wall time, thread-aware nesting) keep the JAX
package's names (``plan``, ``plan.reorder``, ``plan.tune``, ``plan.probe``,
``plan.build``, ``kernel.spmv``, ``kernel.spmm``); the port's spans carry
``backend="torch"``::

    from repro_torch import obs
    with obs.tracing() as buf:
        ...
    events = buf.flush()

Metrics: ``obs.counter(name).inc()``, ``obs.gauge(name).set(v)``,
``obs.histogram(name).observe(v)`` and ``obs.snapshot()``. Exporters:
``obs.write_trace("trace.json", events)`` writes Chrome-trace JSON (load it
in Perfetto), ``validate_chrome_trace`` checks one.
"""
from .spans import (Span, TraceBuffer, enabled, install_sink,  # noqa: F401
                    remove_sink, span, tracing)
from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      counter, gauge, histogram, reset, snapshot)
from .export import (to_chrome_trace, trace_to,  # noqa: F401
                     validate_chrome_trace, write_chrome_trace, write_jsonl,
                     write_trace)

__all__ = [
    "span", "tracing", "enabled", "install_sink", "remove_sink", "Span",
    "TraceBuffer",
    "counter", "gauge", "histogram", "snapshot", "reset",
    "REGISTRY", "Counter", "Gauge", "Histogram",
    "to_chrome_trace", "write_chrome_trace", "write_jsonl", "write_trace",
    "trace_to", "validate_chrome_trace",
]
