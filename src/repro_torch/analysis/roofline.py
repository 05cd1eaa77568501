"""Zero-trace roofline estimates for the serving stack.

The part of ``repro.analysis.roofline`` that the gateway needs: the FLOP
estimate of one query, the analytical floor a saturated replica answers
shed queries from, and MODEL_FLOPS. The reference's HLO parsing
(``analyze``, ``Roofline``, ``collective_stats``) has no counterpart here:
the port counts a step's FLOPs with ``FlopCounterMode`` on its traced
graph (``repro_torch.core.nsm``).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, from
NVIDIA's datasheet, not measured:
  peak_flops = 989.4e12 dense bf16 FLOP/s (tensor cores)
  hbm_bw     = 3.35e12  B/s

The floor stays stamped ``degraded: True``: it is a lower bound from two
datasheet rates, never a learned estimate.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989.4e12  # H100 SXM datasheet, dense bf16
HBM_BW = 3.35e12       # H100 SXM datasheet, HBM3


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
