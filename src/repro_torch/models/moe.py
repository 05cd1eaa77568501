"""Mixture-of-Experts with grouped one-hot dispatch.

Port of ``repro.models.moe``. Tokens are routed with capacity-bounded
one-hot dispatch and combine einsums, as written in the reference, split
into groups of ``cfg.moe_group_size`` so the dispatch tensor stays
``tokens x (group * k * capacity_factor)`` elements, independent of E. This
is the parity path: a gather/scatter (MegaBlocks-style) dispatch would be a
separate, later impl. The reference's sharding hook has no counterpart (the
port has no sharder).

Two details follow the reference's trace rather than torch's defaults:
top-k breaks ties toward the lower expert index, as ``jax.lax.top_k`` does
(a stable descending sort, then a slice: ``torch.topk`` guarantees no
order among ties, and a zero row padded onto the last group has exactly
uniform gates), and the one-hots are an ``eq`` against ``arange``, as
``jax.nn.one_hot`` traces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import spec

AUX_LOSS_WEIGHT = 0.01


def moe_spec(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": spec((d, e), ("embed", None), "small", dtype=torch.float32),
        "wi": spec((e, d, 2, f), ("experts", "embed", None, "mlp")),
        "wo": spec((e, f, d), ("experts", "mlp", "embed")),
    }


def capacity(cfg, group_size: int) -> int:
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4, >= 4


def _softmax(x):
    # jax.nn.softmax written out, as the reference traces it
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first, ties toward the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx, n: int):
    """fp32 one-hot of integer ``idx`` over ``n`` classes (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def apply_moe(p, cfg, x):
    """x (B,S,D) -> (y (B,S,D), aux_loss scalar fp32)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gs = min(cfg.moe_group_size, b * s)
    tokens = b * s
    xt = x.reshape(tokens, d)
    if tokens % gs:  # pad to a group multiple; padded rows are sliced off
        xt = F.pad(xt, (0, 0, 0, gs - tokens % gs))
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)

    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"])
    gates = _softmax(logits)  # (G,gs,E) fp32

    top_vals, top_idx = top_k(gates, k)  # (G,gs,k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)

    c = capacity(cfg, gs)
    eh = one_hot(top_idx, e)  # (G,gs,k,E)
    # Priority order: token-major, then choice rank.
    ehf = eh.reshape(g, gs * k, e)
    pos = torch.cumsum(ehf, dim=1) - ehf  # (G,gs*k,E) slot within expert
    keep = (pos < c).to(torch.float32) * ehf
    disp = keep[..., None] * one_hot(pos.to(torch.int32), c)  # (G,gs*k,E,C)
    comb = disp * top_vals.reshape(g, gs * k)[..., None, None]
    # Fold the k choices back onto tokens (each (token, expert) pair unique).
    disp4 = disp.reshape(g, gs, k, e, c).sum(2).to(x.dtype)
    comb4 = comb.reshape(g, gs, k, e, c).sum(2).to(x.dtype)

    xe = torch.einsum("gsec,gsd->gecd", disp4, xg)  # (G,E,C,D) dispatch
    hi = torch.einsum("gecd,ednf->gecnf", xe, p["wi"].to(x.dtype))
    h = F.silu(hi[..., 0, :].float()).to(x.dtype) * hi[..., 1, :]
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(x.dtype))
    y = torch.einsum("gecd,gsec->gsd", ye, comb4)  # combine
    y = y.reshape(-1, d)[:tokens]

    # Load-balance auxiliary loss (Switch-style): E * sum(frac_tokens * frac_prob)
    frac_tokens = eh.sum(2).mean((0, 1))  # (E,)
    frac_prob = gates.mean((0, 1))  # (E,)
    aux = e * (frac_tokens * frac_prob).sum() * AUX_LOSS_WEIGHT

    return y.reshape(b, s, d), aux


def moe_flops_per_token(cfg) -> int:
    """Forward matmul FLOPs per token (routing + experts at capacity)."""
    d, f, k, cf = cfg.d_model, cfg.d_ff, cfg.top_k, cfg.capacity_factor
    expert = 2 * k * cf * d * 3 * f
    dispatch = 2 * 2 * (cfg.moe_group_size * k * cf) * d
    router = 2 * d * cfg.num_experts
    return int(expert + dispatch + router)
