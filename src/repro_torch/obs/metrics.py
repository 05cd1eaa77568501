"""Metrics registry: counters, gauges, and fixed-bucket latency histograms.

A copy of ``repro.obs.metrics`` (the port imports nothing of the
reference); the serving stack's keys and semantics are unchanged.

Dependency-free (stdlib only) telemetry primitives for the serving
stack. Design constraints, in order:

1. **Warm-path overhead < 3%** (gated by ``benchmarks/bench_obs.py``).
   Counters and gauges are deliberately *unlocked*: every counter in the
   serving stack was previously a plain ``int`` field mutated under its
   owner's lock (``AbacusServer._cond``, ``ClusterFrontend._route_lock``,
   ``PredictionService._lock``), and that synchronization contract is
   unchanged — the metric object just gives the same int a stable name
   and an exposition path. Histograms *are* internally locked (they are
   fed from batch contexts via :meth:`Histogram.observe_many`, one lock
   round per tick, not per query), and defer the per-value bucket fold
   to the reader (``snapshot``/``percentile``) so the serving tick only
   pays one buffered list append.

2. **Order-independent merging.** A fleet snapshot is the merge of every
   replica's snapshot, arriving in whatever order the wire delivers
   them. Counters merge by sum, gauges by max, histograms by element-wise
   bucket addition — all commutative and associative, so
   :func:`merge_snapshots` is order-independent (property-tested in
   ``tests/test_obs.py``).

3. **Exact local quantiles.** Each histogram keeps a bounded window of
   raw samples alongside its buckets: ``percentile()`` on a live
   histogram is exact over the most recent ``window`` observations
   (nearest-rank). Merged snapshots no longer have raw samples, so their
   quantiles come from bucket interpolation (:func:`quantile_from_buckets`).

The registry can be constructed with ``enabled=False``: counters and
gauges keep working (server logic depends on tick numbering etc.), but
callers are expected to skip histogram observes and span recording when
``registry.enabled`` is false — that is the "registry-disabled" baseline
the < 3% overhead gate compares against.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "CounterDict",
    "merge_snapshots",
    "quantile_from_buckets",
    "render_prometheus",
]

# Log-spaced latency bounds (seconds): 10 us .. 60 s, ~1-2.5-5 ladder.
# Chosen once, shared fleet-wide, so bucket merges are always aligned.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class Counter:
    """Monotonic-by-convention counter. Unlocked: callers synchronize
    exactly as they did when this was a bare int field (see module
    docstring). Supports ``+=`` through the owning stats object."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, value) -> None:
        self.value = value

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value (high-water marks, queue depths). Unlocked,
    same contract as :class:`Counter`. Merges by max."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0

    def set(self, value) -> None:
        self.value = value

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket latency histogram with an exact-quantile window.

    Thread-safe. ``observe_many`` amortizes the lock to one round per
    micro-batch tick AND defers the per-value bucket fold: observed
    values land in a pending buffer (one list append), and the
    bisect-per-value work happens when a *reader* asks — ``snapshot()``
    / ``percentile()`` — or every ``FLUSH_AT`` buffered values,
    whichever comes first. Warm serving ticks pay list-append cost; the
    metrics scraper pays the fold, off the hot path. Bucket bounds are
    upper-inclusive (`v <= le[i]`), with an implicit +Inf overflow
    bucket at ``counts[-1]``.
    """

    __slots__ = ("name", "help", "le", "counts", "count", "sum",
                 "min", "max", "_window", "_lock", "_pending",
                 "_pending_n")

    FLUSH_AT = 4096  # bounds pending-buffer memory between scrapes

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 help: str = "", window: int = 2048) -> None:
        self.name = name
        self.help = help
        self.le = tuple(float(b) for b in buckets)
        if list(self.le) != sorted(set(self.le)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.le) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window: deque = deque(maxlen=int(window))
        self._pending: List[List[float]] = []
        self._pending_n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        self.observe_many((value,))

    def observe_many(self, values: Iterable[float]) -> None:
        vals = [float(v) for v in values]
        if not vals:
            return
        with self._lock:
            self._pending.append(vals)
            self._pending_n += len(vals)
            if self._pending_n >= self.FLUSH_AT:
                self._flush_locked()

    def _flush_locked(self) -> None:
        """Fold buffered observations into buckets; lock held."""
        if not self._pending_n:
            return
        le, counts, bl = self.le, self.counts, bisect.bisect_left
        for vals in self._pending:
            for v in vals:
                counts[bl(le, v)] += 1
            self.sum += sum(vals)
            self.count += len(vals)
            lo, hi = min(vals), max(vals)
            if self.min is None or lo < self.min:
                self.min = lo
            if self.max is None or hi > self.max:
                self.max = hi
            self._window.extend(vals)
        self._pending = []
        self._pending_n = 0

    def percentile(self, q: float) -> Optional[float]:
        """Exact nearest-rank quantile over the raw-sample window (the
        most recent ``window`` observations). None when empty."""
        with self._lock:
            self._flush_locked()
            samples = sorted(self._window)
        if not samples:
            return None
        rank = max(1, math.ceil(q * len(samples)))
        return samples[min(rank, len(samples)) - 1]

    def snapshot(self) -> Dict:
        with self._lock:
            self._flush_locked()
            snap = {
                "type": "histogram",
                "le": list(self.le),
                "counts": list(self.counts),
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
            }
            samples = sorted(self._window)
        for key, q in _QUANTILES:
            if samples:
                rank = max(1, math.ceil(q * len(samples)))
                snap[key] = samples[min(rank, len(samples)) - 1]
            else:
                snap[key] = None
        return snap


def quantile_from_buckets(le: Sequence[float], counts: Sequence[int],
                          q: float, hi: Optional[float] = None) -> Optional[float]:
    """Prometheus-style linear interpolation inside the target bucket.

    Used for *merged* snapshots, where raw samples are gone and buckets
    are all that survives the wire. ``hi`` optionally clamps the
    overflow bucket's upper edge (e.g. the merged max)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo = le[i - 1] if i > 0 else 0.0
        up = le[i] if i < len(le) else (hi if hi is not None else le[-1])
        if cum + c >= target:
            frac = (target - cum) / c
            return lo + (up - lo) * min(1.0, max(0.0, frac))
        cum += c
    return le[-1] if hi is None else hi


class MetricsRegistry:
    """Named metric store. ``counter``/``gauge``/``histogram`` are
    idempotent by name: asking twice returns the same object, which is
    how ``ServerStats`` and the exposition plane share one underlying
    int. Callback sources contribute computed gauges (cache sizes,
    queue depth) at snapshot time only — zero hot-path cost."""

    def __init__(self, enabled: bool = True, namespace: str = "abacus") -> None:
        self.enabled = bool(enabled)
        self.namespace = namespace
        self._metrics: Dict[str, object] = {}
        self._callbacks: List[Callable[[], Dict[str, float]]] = []
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  help: str = "", window: int = 2048) -> Histogram:
        return self._get(name, Histogram, buckets=buckets, help=help,
                         window=window)

    def register_callback(self, fn: Callable[[], Dict[str, float]]) -> None:
        with self._lock:
            self._callbacks.append(fn)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-safe snapshot of every metric; callback gauges included.
        Sorted by name so renderings are deterministic."""
        with self._lock:
            metrics = dict(self._metrics)
            callbacks = list(self._callbacks)
        out = {name: m.snapshot() for name, m in sorted(metrics.items())}
        for fn in callbacks:
            try:
                computed = fn()
            except Exception:
                continue
            for name, value in computed.items():
                out[name] = {"type": "gauge", "value": value}
        return out


def merge_snapshots(snaps: Sequence[Dict[str, Dict]]) -> Dict[str, Dict]:
    """Merge registry snapshots: counters sum, gauges max, histogram
    buckets add element-wise. Commutative + associative, so the result
    is independent of replica order. Merged histogram quantiles are
    recomputed from the merged buckets (interpolated, not exact)."""
    merged: Dict[str, Dict] = {}
    for snap in snaps:
        for name, m in snap.items():
            cur = merged.get(name)
            if cur is None:
                merged[name] = dict(m)
                continue
            kind = m.get("type")
            if kind != cur.get("type"):
                continue  # type clash across replicas: first one wins
            if kind == "counter":
                cur["value"] = cur["value"] + m["value"]
            elif kind == "gauge":
                cur["value"] = max(cur["value"], m["value"])
            elif kind == "histogram":
                if list(m["le"]) != list(cur["le"]):
                    continue  # misaligned bounds cannot be added
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], m["counts"])]
                cur["count"] = cur["count"] + m["count"]
                cur["sum"] = cur["sum"] + m["sum"]
                mins = [v for v in (cur["min"], m["min"]) if v is not None]
                maxs = [v for v in (cur["max"], m["max"]) if v is not None]
                cur["min"] = min(mins) if mins else None
                cur["max"] = max(maxs) if maxs else None
    for m in merged.values():
        if m.get("type") == "histogram":
            for key, q in _QUANTILES:
                m[key] = quantile_from_buckets(m["le"], m["counts"], q,
                                               hi=m.get("max"))
    return merged


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def render_prometheus(snapshot: Dict[str, Dict],
                      namespace: str = "abacus") -> str:
    """Render a snapshot (live or merged) as Prometheus text exposition.
    Histogram buckets are emitted cumulatively with ``le`` labels, plus
    ``_sum``/``_count`` series, per the exposition format."""
    lines: List[str] = []
    prefix = f"{namespace}_" if namespace else ""
    for name in sorted(snapshot):
        m = snapshot[name]
        full = prefix + name
        kind = m.get("type", "untyped")
        lines.append(f"# TYPE {full} {kind}")
        if kind == "histogram":
            cum = 0
            for le, c in zip(m["le"], m["counts"]):
                cum += c
                lines.append(f'{full}_bucket{{le="{_prom_num(float(le))}"}} {cum}')
            cum += m["counts"][-1]
            lines.append(f'{full}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{full}_sum {_prom_num(m['sum'])}")
            lines.append(f"{full}_count {m['count']}")
        else:
            lines.append(f"{full} {_prom_num(m.get('value'))}")
    return "\n".join(lines) + "\n"


class CounterDict:
    """Registry-backed mapping with the exact mutation surface of the
    plain dict it replaces (``d[k] += 1``, ``dict(d)``, ``d.keys()``),
    so ``ClusterFrontend.reshard_stats`` keeps its wire shape while the
    counters gain metric names and show up in snapshots."""

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 names: Sequence[str]) -> None:
        self._names = tuple(names)
        self._counters = {n: registry.counter(f"{prefix}{n}_total")
                          for n in self._names}

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return list(self._names)

    def items(self):
        return [(n, self._counters[n].value) for n in self._names]

    def values(self):
        return [self._counters[n].value for n in self._names]

    def get(self, key: str, default=None):
        c = self._counters.get(key)
        return default if c is None else c.value

    def as_dict(self) -> Dict[str, int]:
        return {n: self._counters[n].value for n in self._names}

    def __repr__(self) -> str:
        return f"CounterDict({self.as_dict()!r})"
