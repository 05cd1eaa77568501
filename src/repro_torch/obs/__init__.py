"""repro_torch.obs — the serving stack's telemetry, copied from ``repro.obs``.

- :mod:`repro_torch.obs.metrics` — registry of counters/gauges/histograms
  with order-independent snapshot merging and Prometheus text rendering.
- :mod:`repro_torch.obs.tracing` — per-query spans with cross-process trace
  context (carried in RPC submit frames).
- :mod:`repro_torch.obs.events` — structured JSONL event log for lifecycle
  events (gen swaps, reshards, exclusions, refits, heartbeat deaths).
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
from repro_torch.obs.tracing import SpanSink, make_span, new_context, new_id
from repro_torch.obs.events import EventLog
from repro_torch.obs import events

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
    "SpanSink",
    "make_span",
    "new_context",
    "new_id",
    "EventLog",
    "events",
]
