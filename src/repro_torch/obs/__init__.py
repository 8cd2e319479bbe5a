"""Observability for the port: metrics registry, structured tracer,
exporters (the port's copy of ``repro.obs``, with the same ``__all__``).

Three zero-dependency parts (stdlib only):

* ``metrics`` -- counters / gauges / log-bucketed mergeable histograms
  behind a ``MetricsRegistry`` (``NULL_REGISTRY`` to opt out);
* ``trace`` -- span + counter events with Chrome/Perfetto JSON export
  (``NULL_TRACER`` is the zero-overhead default);
* ``export`` / ``report`` -- Prometheus text + JSON snapshots, and the
  ``python -m repro_torch.obs.report`` stall-attribution CLI.

The store (``lsm.db``, ``lsm.sharded``), the compaction queue, the read
path, both engines and ``serving.engine.ServeEngine`` take a registry and
a tracer; the README's port section lists the names they record.
"""

from repro_torch.obs.export import (metrics_json, prometheus_text,
                                    validate_prometheus_text, write_metrics,
                                    write_prometheus)
from repro_torch.obs.metrics import (NULL_REGISTRY, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     NullRegistry, merge_histograms)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "merge_histograms", "Tracer", "NullTracer",
    "NULL_TRACER", "prometheus_text", "validate_prometheus_text",
    "metrics_json", "write_metrics", "write_prometheus",
]
