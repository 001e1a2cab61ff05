"""repro_torch.obs — tracing + metrics (port of ``src/repro/obs``).

* :mod:`repro_torch.obs.trace` — nested spans with device-lane attribution,
  Chrome ``trace_event`` export, the always-on :func:`stopwatch` timer and
  the span-derived critical path.
* :mod:`repro_torch.obs.metrics` — the typed counter/gauge/histogram
  registry behind every ``stats`` dict the port returns.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, MetricSpec,
                      SCHEMA, schema_markdown)
from .trace import (Span, Tracer, active_tracer, chrome_trace, coverage,
                    critical_path, span, stopwatch, traced, tracing)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricSpec",
    "SCHEMA", "schema_markdown",
    "Span", "Tracer", "active_tracer", "chrome_trace", "coverage",
    "critical_path", "span", "stopwatch", "traced", "tracing",
]
