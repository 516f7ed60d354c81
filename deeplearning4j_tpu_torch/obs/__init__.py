"""The observability plane of the port. Port of
``deeplearning4j_tpu/obs/``: one process-wide metrics registry (counters,
gauges, histograms; Prometheus text), a span tracer, per-request traces
and the flight recorder, SLO tracking, the memory census, fidelity probes
and the compile sentinel. Metric names, kinds, help strings and labels
are the reference's, so that one dashboard reads either package.

Instrumented surfaces (all under ``dl4j_``; ``scripts/check_metric_names
.py`` lints the sites):

- ``serving.scheduler`` — ``dl4j_serving_*`` (slot occupancy, queue
  depth, TTFT / queue-wait / ITL / latency histograms, token, prefill,
  decode and preemption counters, sampler entropy and top-k mass),
  ``dl4j_kv_*`` residency, ``dl4j_workload_*`` by request kind, the
  ``serving.*`` spans, a :class:`RequestTrace` a request, the
  :class:`FlightRecorder` black box and, with ``slo=``, the
  ``dl4j_slo_*{replica}`` gauges;
- ``obs.compiles`` — ``dl4j_compile_*{component}`` from the sentinels
  around the engine's entry points and the nets' train steps;
- ``obs.memory`` — ``dl4j_mem_component_bytes{component, replica}``;
- ``nn.listeners.MetricsListener`` — ``dl4j_train_*``, device memory,
  its own cost;
- ``obs.fidelity`` — ``dl4j_fidelity_*{kind}``.

Not ported: the reference's roofline floors, per-layer profiler,
numerics sentinel and perf-trend plane.
"""

from .registry import (Counter, DEFAULT_BUCKETS, Gauge,  # noqa: F401
                       Histogram, MetricsRegistry)
from .spans import (Span, SpanContext, Tracer, derived_span_id,  # noqa: F401
                    get_tracer, load_spans, span)
from . import memory  # noqa: F401  (memory census)
from .compiles import CompileSentinel  # noqa: F401  (retrace sentinel)
from .memory import (device_memory_stats, emit_census,  # noqa: F401
                     tree_bytes)

_registry = MetricsRegistry(namespace="dl4j")


def get_registry() -> MetricsRegistry:
    """The process-wide registry every built-in instrumentation site
    writes to."""
    return _registry


# imported after the registry exists: slo lazily resolves get_registry()
from .reqtrace import (FlightRecorder, RequestTrace,  # noqa: E402,F401
                       live_flight_recorders, load_flight_records)
from .slo import SLOConfig, SLOTracker  # noqa: E402,F401
from . import fidelity  # noqa: E402,F401  (fidelity probes)
from .fidelity import (FidelityProbe, MeasuredBound,  # noqa: E402,F401
                       assert_trees_close, compare_logits,
                       compare_trees)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "get_registry", "Span", "SpanContext",
           "Tracer", "get_tracer", "derived_span_id", "load_spans",
           "span", "FlightRecorder", "RequestTrace", "SLOConfig",
           "SLOTracker", "live_flight_recorders", "load_flight_records",
           "CompileSentinel", "device_memory_stats", "emit_census",
           "tree_bytes", "FidelityProbe", "MeasuredBound",
           "assert_trees_close", "compare_logits", "compare_trees"]
