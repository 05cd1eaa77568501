"""Serving layer: prediction gateway + cluster fabric + decode engine.

A copy of ``repro.serve``'s exports (the port imports nothing of the
reference), plus the port's ``trace_query``. Import-light by design: the
admission-gateway stack (``TraceStore``,
``PredictionService``, ``AbacusServer``, ``AdmissionController``), the
online-refit loop (``FeedbackStore``, ``OnlineRefitter``), the
multi-host fabric (``ClusterFrontend``, ``GatewayReplica``,
``GenerationPublisher``), and the RPC transport (``RemoteReplica``,
``ReplicaServer``, ``spawn_fleet``) are pure numpy/stdlib and
re-exported here; ``repro_torch.serve.engine`` (the decode engine) is
imported lazily by consumers that need it. All durable maps share one
store contract (``repro_torch.serve.kvstore.KVStoreBase``) over two
interchangeable engines: file-per-key ``JsonFileStore`` and the
append-only ``SegmentLogStore`` (``make_trace_store`` /
``make_feedback_store`` select by name or ``REPRO_STORE_BACKEND``).
"""

from repro_torch.serve.admission import AdmissionController, Verdict
from repro_torch.serve.cluster import (ClusterFrontend, GatewayReplica,
                                       GenerationPublisher, HashRing,
                                       ReplicaNotRunning, ReplicaUnavailable,
                                       RingDiff)
from repro_torch.serve.feedback_store import (CalibrationWindow, FeedbackStore,
                                              Observation, SegmentFeedbackStore,
                                              TenantCalibration,
                                              make_feedback_store)
from repro_torch.serve.kvstore import (JsonFileStore, KVStoreBase, SegmentLogStore,
                                       atomic_write_json, store_backend)
from repro_torch.serve.prediction_service import (PredictionService, Query,
                                                  config_fingerprint,
                                                  trace_query)
from repro_torch.serve.refit import ModelGeneration, OnlineRefitter
from repro_torch.serve.server import (AbacusServer, DeadlineExceeded,
                                      QuotaExceeded)
from repro_torch.serve.trace_store import (SegmentTraceStore, TraceStore,
                                           make_trace_store)

# Lazy (PEP 562) so `python -m repro_torch.serve.rpc` does not import the rpc
# module twice (once via this package, once as __main__ — runpy warns).
_RPC_EXPORTS = ("RemoteReplica", "ReplicaServer", "spawn_replica",
                "spawn_fleet", "shutdown_fleet")


def __getattr__(name):
    if name in _RPC_EXPORTS:
        from repro_torch.serve import rpc

        return getattr(rpc, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["AdmissionController", "Verdict", "PredictionService", "Query",
           "config_fingerprint", "trace_query", "AbacusServer", "DeadlineExceeded",
           "QuotaExceeded", "TraceStore", "SegmentTraceStore",
           "make_trace_store",
           "FeedbackStore", "SegmentFeedbackStore", "make_feedback_store",
           "Observation", "CalibrationWindow",
           "TenantCalibration",
           "OnlineRefitter", "ModelGeneration", "KVStoreBase",
           "JsonFileStore", "SegmentLogStore", "store_backend",
           "atomic_write_json", "ClusterFrontend", "GatewayReplica",
           "GenerationPublisher", "HashRing", "RingDiff",
           "ReplicaUnavailable", "ReplicaNotRunning", "RemoteReplica",
           "ReplicaServer", "spawn_replica", "spawn_fleet",
           "shutdown_fleet"]
