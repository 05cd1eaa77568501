"""Mixture-of-Experts with grouped one-hot dispatch.

Port of ``repro.models.moe``. Tokens are routed with capacity-bounded
one-hot dispatch and combine einsums, as written in the reference, split
into groups of ``cfg.moe_group_size`` so the dispatch tensor stays
``tokens x (group * k * capacity_factor)`` elements, independent of E. This
is the parity path: a gather/scatter (MegaBlocks-style) dispatch would be a
separate, later impl. ``shard`` is the model's sharder hook: the dispatch
and combine tensors and the experts' inputs and outputs are constrained at
the reference's points (experts over ``model`` under expert parallelism).

Two details follow the reference's trace rather than torch's defaults:
top-k breaks ties toward the lower expert index, as ``jax.lax.top_k`` does
(a stable descending sort, then a slice: ``torch.topk`` guarantees no
order among ties, and a zero row padded onto the last group has exactly
uniform gates), and the one-hots are an ``eq`` against ``arange``, as
``jax.nn.one_hot`` traces.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, local_map, reduce_partials,
                                              whole_sequence_grad)
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


def apply_moe(p, cfg, x, shard=None):
    """x (B,S,D) -> (y (B,S,D), aux_loss scalar fp32)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _per_shard(p, cfg, x)
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
    disp4 = constrain(shard, "moe_disp", disp4)
    comb4 = constrain(shard, "moe_disp", comb4)

    xe = torch.einsum("gsec,gsd->gecd", disp4, xg)  # (G,E,C,D) dispatch
    xe = constrain(shard, "moe_xe", xe)
    hi = torch.einsum("gecd,ednf->gecnf", xe, p["wi"].to(x.dtype))
    h = F.silu(hi[..., 0, :].float()).to(x.dtype) * hi[..., 1, :]
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(x.dtype))
    ye = constrain(shard, "moe_xe", ye)
    y = torch.einsum("gecd,gsec->gsd", ye, comb4)  # combine
    y = y.reshape(-1, d)[:tokens]

    # Load-balance auxiliary loss (Switch-style): E * sum(frac_tokens * frac_prob)
    frac_tokens = eh.sum(2).mean((0, 1))  # (E,)
    frac_prob = gates.mean((0, 1))  # (E,)
    aux = e * (frac_tokens * frac_prob).sum() * AUX_LOSS_WEIGHT

    return y.reshape(b, s, d), aux


def expert_split(wi, wo, x):
    """The mesh dims (indices) over which ``wi`` and ``wo`` both split their
    expert dim and the DTensor ``x`` does not split its rows: there the
    experts stay split for compute, and ``_per_shard`` runs each rank's own
    on the tokens that all ranks of the dim hold alike. Empty for plain
    tensors."""
    from torch.distributed.tensor import DTensor

    if not all(isinstance(t, DTensor) for t in (wi, wo, x)):
        return ()
    return tuple(i for i, (a, b, r) in enumerate(zip(wi.placements, wo.placements, x.placements))
                 if a.is_shard(0) and b.is_shard(0) and not r.is_shard(0))


def _experts(cfg, router, wi, wo, x, e0: int):
    """One rank's part of the layer: its tokens ``x`` (B,S,D) routed over all
    experts, dispatched to and combined from its experts ``e0`` onwards (as
    many as ``wi`` holds). Returns (y, the tokens' expert counts summed, the
    gates summed, the routed rows), y a partial sum over the experts."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gs = min(cfg.moe_group_size, b * s)
    tokens = b * s
    xt = x.reshape(tokens, d)
    if tokens % gs:
        xt = F.pad(xt, (0, 0, 0, gs - tokens % gs))
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)
    gates = _softmax(torch.einsum("gsd,de->gse", xg.float(), router))
    top_vals, top_idx = top_k(gates, k)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    c = capacity(cfg, gs)
    eh = one_hot(top_idx, e)
    ehf = eh.reshape(g, gs * k, e)
    pos = torch.cumsum(ehf, dim=1) - ehf
    keep = (pos < c).to(torch.float32) * ehf
    disp = keep[..., None] * one_hot(pos.to(torch.int32), c)
    comb = disp * top_vals.reshape(g, gs * k)[..., None, None]
    mine = slice(e0, e0 + wi.shape[0])
    disp4 = disp.reshape(g, gs, k, e, c).sum(2)[:, :, mine].to(x.dtype)
    comb4 = comb.reshape(g, gs, k, e, c).sum(2)[:, :, mine].to(x.dtype)
    xe = torch.einsum("gsec,gsd->gecd", disp4, xg)
    hi = torch.einsum("gecd,ednf->gecnf", xe, wi.to(x.dtype))
    h = F.silu(hi[..., 0, :].float()).to(x.dtype) * hi[..., 1, :]
    ye = torch.einsum("gecf,efd->gecd", h, wo.to(x.dtype))
    y = torch.einsum("gecd,gsec->gsd", ye, comb4).reshape(-1, d)[:tokens]
    rows = torch.tensor(float(g * gs), device=x.device)
    return y.reshape(b, s, d), eh.sum(2).sum((0, 1)), gates.sum((0, 1)), rows


def _per_shard(p, cfg, x):
    """The layer on DTensors, each rank on its own tokens and experts
    (``local_map``): DTensor cannot multiply the dispatch's groups and
    experts split over two mesh dims once its einsums merge them. Tokens
    keep their row split where each rank's rows make whole groups of the
    reference's grouping (else, and over any mesh dim that splits the
    experts, they are made whole); every rank of an expert split routes the same tokens over all
    experts and serves its own, and their outputs are summed. The load
    statistics are summed over the row split before the aux loss, so it is
    the whole batch's, as in the reference."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, whole = x.device_mesh, Replicate()
    experts = [i for i, pl in enumerate(p["wi"].placements) if pl.is_shard() and pl.dim == 0]
    split = [i for i, pl in enumerate(x.placements)
             if pl.is_shard() and pl.dim % 3 == 0 and i not in experts]
    b, s, _ = x.shape
    gs = min(cfg.moe_group_size, b * s)
    if (b * s) % gs or b % math.prod(mesh.size(i) for i in split) \
            or (b // math.prod(mesh.size(i) for i in split)) * s % gs:
        split = []  # a group would span ranks: every rank routes all the tokens
    x_pl, y_pl, stat_pl, w_pl = [], [], [], []
    for i, pl in enumerate(x.placements):
        rows = i in split
        x_pl.append(Shard(0) if rows else whole)
        y_pl.append(Shard(0) if rows else Partial() if i in experts else whole)
        stat_pl.append(Partial() if rows or i in experts else whole)
        w_pl.append(Shard(0) if i in experts else whole)

    def local(router, wi, wo, xl):
        shard = 0
        for i in experts:  # the rank's expert shard, major to minor
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
        y, *stats = _experts(cfg, router, wi, wo, xl, shard * wi.shape[0])
        # every expert shard routes alike: the first one's statistics count
        return (y, *(t * float(shard == 0) for t in stats))

    fn = local_map(local, (y_pl, stat_pl, stat_pl, stat_pl),
                   ([whole] * len(x_pl), w_pl, w_pl, x_pl), mesh)
    y, *stats = fn(p["router"], p["wi"], p["wo"], x)
    tok, prob, rows = (reduce_partials(t) for t in stats)
    aux = cfg.num_experts * ((tok / rows) * (prob / rows)).sum() * AUX_LOSS_WEIGHT
    return whole_sequence_grad(y), aux


def moe_flops_per_token(cfg) -> int:
    """Forward matmul FLOPs per token (routing + experts at capacity)."""
    d, f, k, cf = cfg.d_model, cfg.d_ff, cfg.top_k, cfg.capacity_factor
    expert = 2 * k * cf * d * 3 * f
    dispatch = 2 * 2 * (cfg.moe_group_size * k * cf) * d
    router = 2 * d * cfg.num_experts
    return int(expert + dispatch + router)
