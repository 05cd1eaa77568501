"""Per-query tracing: spans for every lifecycle stage of a query.

A *trace context* is a tiny dict ``{"trace": <id>, "span": <root id>}``
attached to a :class:`~repro_torch.serve.prediction_service.Query` and carried
verbatim inside the RPC submit frame, so the stages a query passes
through — frontend routing, a remote replica's tick, a hedge re-issued
to a different process — all stamp spans with the same trace id. Server-
side spans ride back to the frontend inside the estimate dict under the
``"_trace"`` key; the frontend harvests them into its
:class:`SpanSink`, yielding one coherent cross-process trace.

Span taxonomy (``name`` field):

==============  =============================================
``submit``      root span; frontend accepted the query
``route``       ring lookup chose a replica (attrs: replica)
``queue_wait``  time between enqueue and its tick starting
``tick_batch``  the micro-batch tick that served the query
``cold_trace``  record resolution ran cold train-step traces
``ensemble``    the tick's single ensemble pass
``reply``       estimate resolution back onto the future
``hedge``       duplicate issued to the next ring owner
``retry``       re-submit after a replica failure
``replay``      re-submit after parking across a cutover
==============  =============================================

Spans are plain dicts (JSON-safe by construction): ``trace``, ``span``,
``parent``, ``name``, ``ts`` (wall epoch seconds), ``dur_s``, ``pid``,
plus optional ``attrs``. No clock sync is attempted across processes;
``ts`` values are per-host wall clocks and ``dur_s`` comes from
``perf_counter`` deltas.

A copy of ``repro.obs.tracing`` (the port imports nothing of the
reference): span names and fields are the reference's.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["new_id", "new_context", "make_span", "SpanSink"]


def new_id() -> str:
    """64-bit random hex id (trace or span)."""
    return os.urandom(8).hex()


def new_context() -> Dict[str, str]:
    """Fresh trace context: the root span id doubles as the parent for
    every stage span recorded downstream."""
    return {"trace": new_id(), "span": new_id()}


def make_span(trace: str, name: str, dur_s: float, *,
              parent: Optional[str] = None, ts: Optional[float] = None,
              span_id: Optional[str] = None, **attrs) -> Dict:
    span = {
        "trace": trace,
        "span": span_id if span_id is not None else new_id(),
        "parent": parent,
        "name": name,
        "ts": time.time() if ts is None else ts,
        "dur_s": float(dur_s),
        "pid": os.getpid(),
    }
    if attrs:
        span["attrs"] = attrs
    return span


class SpanSink:
    """Bounded, thread-safe span buffer. One per frontend/server; holds
    the most recent ``maxlen`` spans for inspection and test assertions.
    Tracing is opt-in per query, so in practice this holds the spans of
    explicitly traced queries, not the whole stream."""

    def __init__(self, maxlen: int = 4096) -> None:
        self._spans: deque = deque(maxlen=int(maxlen))
        self._lock = threading.Lock()

    def record(self, span: Dict) -> None:
        with self._lock:
            self._spans.append(span)

    def extend(self, spans) -> None:
        with self._lock:
            self._spans.extend(spans)

    def for_trace(self, trace_id: str) -> List[Dict]:
        """All spans of one trace, ordered by start timestamp."""
        with self._lock:
            spans = [s for s in self._spans if s.get("trace") == trace_id]
        return sorted(spans, key=lambda s: (s.get("ts", 0.0), s.get("name", "")))

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)
