"""Feature engineering (paper §3.2).

A copy of ``repro.core.features`` (the port imports nothing of the
reference). Structure-independent features (Table 2): batch size, input
size, channels, learning rate, epoch, optimizer, #layers, FLOPs, #params —
plus a platform tag so one model generalizes across hardware (paper §4,
two systems). Structure-dependent features: the NSM vector
(``repro_torch.core.nsm``).

The port's records carry ``PLATFORM_TORCH_CUDA``: their ``mem_bytes`` is
the torch allocator's peak on the card and their ``time_s`` a CUDA-event
step time, where the reference's records (platform 0) hold XLA's
``memory_analysis`` bytes and host wall time. The two measure different
things, so a predictor is never fit on a mix of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

OPTIMIZERS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}

# Platform tag of records profiled by the port: PyTorch on a CUDA card.
PLATFORM_TORCH_CUDA = 1

SI_FEATURES = ["batch_size", "input_size", "channels", "learning_rate",
               "epoch", "optimizer", "layers", "flops", "params",
               "platform", "dtype_bytes"]


@dataclasses.dataclass
class ProfileRecord:
    """One profiled training/inference configuration (a data point)."""
    model_name: str
    family: str
    batch_size: int
    input_size: int          # image H(=W) or sequence length
    channels: int            # input channels or d_model
    learning_rate: float
    epoch: int
    optimizer: str
    layers: int
    flops: float             # per-step FLOPs (analytic or HLO-derived)
    params: int
    nsm_edges: Dict          # {(src,dst): count}
    time_s: float = 0.0      # measured wall time per step
    mem_bytes: float = 0.0   # peak device bytes (the port: torch allocator peak)
    platform: int = 0        # platform tag (paper: System 1 / System 2)
    dtype_bytes: int = 4
    extra: Optional[Dict] = None

    def si_vector(self) -> np.ndarray:
        return np.array([
            self.batch_size,
            self.input_size,
            self.channels,
            self.learning_rate,
            self.epoch,
            OPTIMIZERS.get(self.optimizer, len(OPTIMIZERS)),
            self.layers,
            np.log1p(self.flops),
            np.log1p(self.params),
            self.platform,
            self.dtype_bytes,
        ], np.float64)


def record_to_json(r: "ProfileRecord") -> Dict:
    d = dataclasses.asdict(r)
    d["nsm_edges"] = {f"{a}->{b}": v for (a, b), v in r.nsm_edges.items()}
    return d


def record_from_json(d: Dict) -> "ProfileRecord":
    d = dict(d)
    d["nsm_edges"] = {tuple(k.split("->")): v
                      for k, v in d["nsm_edges"].items()}
    return ProfileRecord(**d)


def design_matrix(records: List[ProfileRecord], nsm_featurizer=None,
                  graph_featurizer=None) -> np.ndarray:
    """One (N, D) design matrix for N records."""
    blocks = [np.stack([r.si_vector() for r in records])]
    if nsm_featurizer is not None:
        blocks.append(nsm_featurizer.vectors([r.nsm_edges for r in records]))
    if graph_featurizer is not None:
        blocks.append(np.stack([graph_featurizer.vector(r.nsm_edges)
                                for r in records]))
    return np.concatenate(blocks, axis=1)


def targets(records: List[ProfileRecord]):
    t = np.array([r.time_s for r in records], np.float64)
    m = np.array([r.mem_bytes for r in records], np.float64)
    return t, m


def mre(pred: np.ndarray, true: np.ndarray) -> float:
    """Mean relative error — the paper's metric."""
    true = np.asarray(true, np.float64)
    pred = np.asarray(pred, np.float64)
    denom = np.maximum(np.abs(true), 1e-12)
    return float(np.mean(np.abs(pred - true) / denom))
