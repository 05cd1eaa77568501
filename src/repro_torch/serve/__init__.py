"""Serving: the batched greedy decode engine and the prediction service."""

from repro_torch.serve.prediction_service import (PredictionService, Query,
                                                  config_fingerprint, trace_query)

__all__ = ["PredictionService", "Query", "config_fingerprint", "trace_query"]
