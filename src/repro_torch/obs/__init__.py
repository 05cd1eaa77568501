"""repro_torch.obs — the serving stack's telemetry, copied from ``repro.obs``.

- :mod:`repro_torch.obs.metrics` — registry of counters/gauges/histograms
  with order-independent snapshot merging and Prometheus text rendering.

Tracing and the event log arrive with the serving fleet (ROADMAP Queue A
item 18).
"""
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
    quantile_from_buckets,
    render_prometheus,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "merge_snapshots",
    "quantile_from_buckets",
    "render_prometheus",
]
