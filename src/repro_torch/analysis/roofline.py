"""Roofline terms of a traced per-rank step, and zero-trace estimates.

Port of ``repro.analysis.roofline``. ``analyze(graph)`` derives the dry
run's roofline record from one rank's ``make_fx`` graph (``analysis.hlo``:
FLOPs, HBM bytes and collective bytes; a live-bytes count for memory), in
place of the reference's compiled-HLO analysis. The serving stack's part is
as in the reference: the FLOP estimate of one query, the analytical floor a
saturated replica answers shed queries from, and MODEL_FLOPS.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from
NVIDIA's datasheet, not measured:
  peak_flops = 989.4e12 dense bf16 FLOP/s (tensor cores)
  hbm_bw     = 3.35e12  B/s
  link_bw    = 450e9    B/s, one direction of NVLink 4 (900 GB/s both ways)

Terms (seconds, per step, per rank; the traced graph is already one rank's):
  compute    = FLOPs / peak_flops
  memory     = HBM bytes / hbm_bw
  collective = weighted collective bytes / link_bw
               (all-reduce counts 2x — a ring all-reduce moves ~2 x size per
                rank; all-gather / reduce-scatter / all-to-all 1x)

The floor stays stamped ``degraded: True``: it is a lower bound from two
datasheet rates, never a learned estimate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989.4e12  # H100 SXM datasheet, dense bf16
HBM_BW = 3.35e12       # H100 SXM datasheet, HBM3
LINK_BW = 450e9        # H100 SXM datasheet, NVLink 4, one direction; not measured


def collective_stats(graph) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind {count, bytes, weighted} of a traced graph."""
    from repro_torch.analysis import hlo as hlo_lib

    out: Dict[str, Dict[str, float]] = {}
    for node in graph.graph.nodes:
        if node.op != "call_function" or hlo_lib.coll_kind(node.target) is None:
            continue
        c = hlo_lib.node_cost(node)
        kind = next(iter(c.coll_counts))
        e = out.setdefault(kind, {"count": 0, "bytes": 0.0, "weighted": 0.0})
        e["count"] += 1
        e["bytes"] += c.coll_bytes
        e["weighted"] += c.coll_weighted
    return out


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_bytes: float        # raw result bytes
    collective_weighted: float     # link-time-weighted bytes
    collectives: Dict[str, Dict[str, float]]
    peak_hbm_per_device: float
    argument_bytes: float
    output_bytes: float
    temp_bytes: float

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_weighted / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self, model_flops_per_device: Optional[float] = None) -> Dict:
        d = {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_weighted_bytes": self.collective_weighted,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "peak_hbm_gib": self.peak_hbm_per_device / 2**30,
            "argument_gib": self.argument_bytes / 2**30,
            "temp_gib": self.temp_bytes / 2**30,
            "collectives": self.collectives,
        }
        if model_flops_per_device:
            d["model_flops_per_device"] = model_flops_per_device
            d["useful_flop_fraction"] = model_flops_per_device / max(self.flops, 1)
            d["mfu_bound"] = (model_flops_per_device / PEAK_FLOPS) / max(
                self.t_bound, 1e-12)
        return d


def analyze(graph) -> Roofline:
    """Roofline terms of one rank's traced step (a ``make_fx`` graph).

    FLOPs, bytes and collectives come from ``analysis.hlo.analyze_graph``.
    Memory is a live-bytes count over the same graph, run op by op
    (``analysis.hlo.live_bytes``): ``argument`` is the rank's state and
    batch shards, ``temp`` the most op results alive at once, and the peak
    their sum; eager PyTorch frees a result after its last use and donates
    nothing, so the old state stays live beside the new one.
    """
    from repro_torch.analysis import hlo as hlo_lib

    cost = hlo_lib.analyze_graph(graph)
    mem = hlo_lib.live_bytes(graph)
    colls = {k: {"count": v} for k, v in cost.coll_counts.items()}
    return Roofline(
        flops=cost.flops,
        bytes_accessed=cost.bytes,
        collective_bytes=cost.coll_bytes,
        collective_weighted=cost.coll_weighted,
        collectives=colls,
        peak_hbm_per_device=mem["peak"],
        argument_bytes=mem["argument"],
        output_bytes=mem["output"],
        temp_bytes=mem["temp"],
    )


def flops_estimate(cfg, batch: int, seq: int) -> float:
    """Zero-trace FLOP estimate for one (config, batch, seq) query.

    Configs carrying a ``dots`` attribute (the scenario zoo's synthetic
    profiles, where cost laws are linear in ``batch*seq*dots``) use it
    directly; real transformer configs fall back to the standard
    ``12 * layers * d_model^2`` per-token forward approximation.
    """
    dots = getattr(cfg, "dots", None)
    if dots is not None:
        return float(batch) * float(seq) * float(dots) * 1e6
    layers = int(getattr(cfg, "num_layers", getattr(cfg, "layers", 1)) or 1)
    d_model = int(getattr(cfg, "d_model", getattr(cfg, "hidden_size", 0))
                  or 1024)
    return 12.0 * layers * float(d_model) ** 2 * float(batch) * float(seq)


def floor_estimate(cfg, batch: int, seq: int) -> Dict[str, float]:
    """Analytical roofline floor: the cheapest defensible answer.

    ``inference_time = flops / device_flops`` bounded below by the HBM
    streaming time of the (approximate) parameter bytes — no trace, no
    model build, O(1). Saturated replicas answer shed queries from this
    floor instead of queueing them; the estimate is stamped
    ``degraded: True`` so consumers can tell it from a learned one.
    """
    flops = flops_estimate(cfg, batch, seq)
    dots = getattr(cfg, "dots", None)
    if dots is not None:
        param_bytes = 4.0 * float(dots) * 1e5
    else:
        layers = int(getattr(cfg, "num_layers",
                             getattr(cfg, "layers", 1)) or 1)
        d_model = int(getattr(cfg, "d_model",
                              getattr(cfg, "hidden_size", 0)) or 1024)
        param_bytes = 4.0 * 12.0 * layers * float(d_model) ** 2
    act_bytes = 4.0 * float(batch) * float(seq) * 1024.0
    mem_bytes = param_bytes + act_bytes
    time_s = max(flops / PEAK_FLOPS, mem_bytes / HBM_BW)
    return {
        "model": "roofline-floor",
        "time_s": float(time_s),
        "memory_bytes": float(mem_bytes),
        "flops": float(flops),
        "degraded": True,
    }


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n = n_active if cfg.num_experts else n_params
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * tokens)
