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
                                              shard_index, split_idle, whole_sequence_grad)
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


def _route(router, k: int, xg):
    """(gates, top-k weights renormalised, top-k experts) of the tokens ``xg``
    (G, gs, D); the gates fp32."""
    gates = _softmax(torch.einsum("gsd,de->gse", xg.float(), router))
    top_vals, top_idx = top_k(gates, k)
    return gates, top_vals / top_vals.sum(-1, keepdim=True), top_idx


def _slots(cfg, top_vals, top_idx, gs: int):
    """The routing choices of whole groups of ``gs`` tokens (any leading
    shape, (.., k) each) as one-hots: (the choices (.., k, E), the dispatch
    and the combine weights (G, gs, E, C)), fp32; no combine weights
    without ``top_vals``. Slots are given in priority order: token-major,
    then choice rank."""
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(cfg, gs)
    eh = one_hot(top_idx, e)
    ehf = eh.reshape(-1, gs * k, e)
    g = ehf.shape[0]
    pos = torch.cumsum(ehf, dim=1) - ehf  # (G,gs*k,E) slot within expert
    keep = (pos < c).to(torch.float32) * ehf
    disp = keep[..., None] * one_hot(pos.to(torch.int32), c)  # (G,gs*k,E,C)
    # Fold the k choices back onto tokens (each (token, expert) pair unique).
    disp4 = disp.reshape(g, gs, k, e, c).sum(2)
    if top_vals is None:
        return eh, disp4, None
    comb = disp * top_vals.reshape(g, gs * k)[..., None, None]
    return eh, disp4, comb.reshape(g, gs, k, e, c).sum(2)


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

    gates, top_vals, top_idx = _route(p["router"], k, xg)  # (G,gs,E) fp32, (G,gs,k)
    eh, disp4, comb4 = _slots(cfg, top_vals, top_idx, gs)
    disp4 = constrain(shard, "moe_disp", disp4.to(x.dtype))
    comb4 = constrain(shard, "moe_disp", comb4.to(x.dtype))

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


def _experts(cfg, router, wi, wo, x, e0: int):
    """One rank's part of the layer: its tokens ``x`` (B,S,D) routed over all
    experts, dispatched to and combined from its experts ``e0`` onwards (as
    many as ``wi`` holds). Returns (y, the tokens' expert counts summed, the
    gates summed, the routed rows), y a partial sum over the experts."""
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, b * s)
    tokens = b * s
    xt = x.reshape(tokens, d)
    if tokens % gs:
        xt = F.pad(xt, (0, 0, 0, gs - tokens % gs))
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)
    gates, top_vals, top_idx = _route(router, cfg.top_k, xg)
    eh, disp4, comb4 = _slots(cfg, top_vals, top_idx, gs)
    mine = slice(e0, e0 + wi.shape[0])
    disp4, comb4 = disp4[:, :, mine].to(x.dtype), comb4[:, :, mine].to(x.dtype)
    xe = torch.einsum("gsec,gsd->gecd", disp4, xg)
    hi = torch.einsum("gecd,ednf->gecnf", xe, wi.to(x.dtype))
    h = F.silu(hi[..., 0, :].float()).to(x.dtype) * hi[..., 1, :]
    ye = torch.einsum("gecf,efd->gecd", h, wo.to(x.dtype))
    y = torch.einsum("gecd,gsec->gsd", ye, comb4).reshape(-1, d)[:tokens]
    rows = torch.tensor(float(g * gs), device=x.device)
    return y.reshape(b, s, d), eh.sum(2).sum((0, 1)), gates.sum((0, 1)), rows


def _row_split(cfg, x, experts):
    """(split, spans): the mesh dims over which the layer keeps the rows of
    the DTensor ``x`` split (those that split them, but ``experts``), and
    whether a group of the reference's grouping spans ranks there. The rows
    stay split where each rank's tokens make whole groups, or where they
    make a whole share of one (``spans``: a decode step's batch of one token
    a row); else they are made whole."""
    split = [i for i, pl in enumerate(x.placements)
             if pl.is_shard() and pl.dim % 3 == 0 and i not in experts]
    b, s, _ = x.shape
    gs = min(cfg.moe_group_size, b * s)
    n = math.prod(x.device_mesh.size(i) for i in split)
    if (b * s) % gs or b % n:
        return [], False
    mine = b // n * s
    if mine % gs == 0:
        return split, False
    return (split, True) if gs % mine == 0 else ([], False)


def compute_split(cfg, wi, wo, x):
    """The mesh dims (indices) over which ``wi`` and ``wo`` keep their split
    for compute, as GSPMD divides the expert products, where a gather would
    have every rank of the dim repeat them on the same tokens:

    - those over which both split their expert dim and the DTensor ``x``
      does not split its rows: each rank serves its own experts on the
      tokens that all ranks of the dim hold alike (``_per_shard``);
    - where a group spans the ranks that split the rows of ``x``
      (``_row_split``), those of them over which both split d_model (an
      FSDP split over "data"): the dispatched tokens are split over d_model
      to meet them (``_spanning``).

    Empty for plain tensors."""
    from torch.distributed.tensor import DTensor

    if not all(isinstance(t, DTensor) for t in (wi, wo, x)):
        return ()
    experts = tuple(i for i, (a, b, r) in enumerate(zip(wi.placements, wo.placements,
                                                         x.placements))
                    if a.is_shard(0) and b.is_shard(0) and not r.is_shard(0))
    split, spans = _row_split(cfg, x, [i for i, pl in enumerate(wi.placements)
                                       if pl.is_shard(0)])
    kept = tuple(i for i in split if spans and wi.placements[i].is_shard(1)
                 and wo.placements[i].is_shard(2))
    # the combine takes the rows whole over them: they must still make whole
    # groups or a share of one
    b, s, _ = x.shape
    gs = min(cfg.moe_group_size, b * s)
    n = b // math.prod(x.device_mesh.size(i) for i in split if i not in kept) * s
    return experts + (kept if n % gs == 0 or gs % n == 0 else ())


def _window(first: int, n: int, gs: int):
    """(groups, positions): the slices that hold the tokens ``first`` to
    ``first + n`` of groups of ``gs``, which lie in one group or make whole
    ones."""
    if n >= gs:
        return slice(first // gs, (first + n) // gs), slice(None)
    return slice(first // gs, first // gs + 1), slice(first % gs, first % gs + n)


def _per_shard(p, cfg, x):
    """The layer on DTensors, each rank on its own tokens and experts
    (``local_map``): DTensor cannot multiply the dispatch's groups and
    experts split over two mesh dims once its einsums merge them. Tokens
    keep their row split where each rank's rows make whole groups of the
    reference's grouping (else, and over any mesh dim that splits the
    experts, they are made whole); every rank of an expert split routes the same tokens over all
    experts and serves its own, and their outputs are summed. The load
    statistics are summed over the row split before the aux loss, so it is
    the whole batch's, as in the reference. Where a group spans the ranks
    of the row split, ``_spanning`` runs the layer."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, whole = x.device_mesh, Replicate()
    experts = [i for i, pl in enumerate(p["wi"].placements) if pl.is_shard(0)]
    split, spans = _row_split(cfg, x, experts)
    if spans:
        return _spanning(p, cfg, x, experts, split)
    x_pl, y_pl, stat_pl, w_pl = [], [], [], []
    for i, pl in enumerate(x.placements):
        rows = i in split
        x_pl.append(Shard(0) if rows else whole)
        y_pl.append(Shard(0) if rows else Partial() if i in experts else whole)
        stat_pl.append(Partial() if rows or i in experts else whole)
        w_pl.append(Shard(0) if i in experts else whole)

    def local(router, wi, wo, xl):
        shard = shard_index(mesh, experts)
        y, *stats = _experts(cfg, router, wi, wo, xl, shard * wi.shape[0])
        # every expert shard routes alike: the first one's statistics count
        return (y, *(t * float(shard == 0) for t in stats))

    fn = local_map(local, (y_pl, stat_pl, stat_pl, stat_pl),
                   ([whole] * len(x_pl), w_pl, w_pl, x_pl), mesh)
    y, *stats = fn(p["router"], p["wi"], p["wo"], x)
    tok, prob, rows = (reduce_partials(t) for t in stats)
    aux = cfg.num_experts * ((tok / rows) * (prob / rows)).sum() * AUX_LOSS_WEIGHT
    return whole_sequence_grad(y), aux


def _spanning(p, cfg, x, experts, split):
    """The layer where each rank of the row split ``split`` holds a share of
    one group (a decode step's batch), in five ``local_map`` regions, each
    product at the share a device that GSPMD gives it:

    - route: each rank its own rows, split over every mesh dim that divides
      them (``split_idle``: the expert dims too); only the top-k choices and
      weights are then gathered, so that every rank fills the group's slots
      in the reference's token-major order (capacity and drops exactly the
      reference's);
    - dispatch: each rank its own rows of ``split`` into its own experts, a
      partial sum over ``split``, summed into the experts' inputs;
    - the experts' two products, on each rank's experts; where ``wi`` and
      ``wo`` keep a split of d_model (``compute_split``), the first is a
      partial sum over it, summed before the gate, and the second gives its
      share of d_model;
    - combine: each rank's experts into its own rows (all of them where its
      share of the experts' outputs is a share of d_model), a partial sum
      over the experts.

    The output comes back split over ``split`` on its rows and partial over
    the experts, as ``_per_shard``'s."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, whole = x.device_mesh, Replicate()
    b, s, d = x.shape
    e, k, dims = cfg.num_experts, cfg.top_k, range(mesh.ndim)
    gs = min(cfg.moe_group_size, b * s)
    g = b * s // gs
    local_e = e // math.prod(mesh.size(i) for i in experts)
    wi, wo = p["wi"], p["wo"]
    kept = [i for i in split if wi.placements[i].is_shard(1) and wo.placements[i].is_shard(2)]
    rows = [i for i in split if i not in kept]
    alike = [whole] * mesh.ndim

    def on(*pairs):  # placements: the first (dims, placement) holding each dim, else whole
        return [next((pl for ds, pl in pairs if i in ds), whole) for i in dims]

    route = split_idle(x, 0)
    stat = [Partial() if pl.is_shard() else whole for pl in route]

    def route_local(router, xl):
        gates, top_vals, top_idx = _route(router, k, xl.reshape(1, -1, d))
        return (top_vals.reshape(-1, s, k), top_idx.reshape(-1, s, k),
                one_hot(top_idx, e).sum(2).sum((0, 1)), gates.sum((0, 1)))

    top_vals, top_idx, tok, prob = local_map(route_local, (route, route, stat, stat),
                                             (alike, route), mesh)(p["router"], x)
    top_vals, top_idx = (t.redistribute(mesh, alike) for t in (top_vals, top_idx))

    def slots(idx, vals, by):
        """The dispatch (without ``vals``) or combine weights of this rank's
        experts and of its tokens of the row split ``by``, and their
        groups."""
        _, disp, comb = _slots(cfg, vals, idx, gs)
        n = b // math.prod(mesh.size(i) for i in by) * s
        groups, at = _window(shard_index(mesh, by) * n, n, gs)
        first = shard_index(mesh, experts) * local_e
        return (disp if vals is None else comb)[groups, at, first:first + local_e], groups

    def dispatch(idx, xl):
        disp, groups = slots(idx, None, split)
        xe = torch.einsum("gsec,gsd->gecd", disp.to(xl.dtype), xl.reshape(disp.shape[0], -1, d))
        if (groups.start, groups.stop) == (0, g):
            return xe
        return F.pad(xe, (0, 0, 0, 0, 0, 0, groups.start, g - groups.stop))  # the other groups

    xe = local_map(dispatch, on((split, Partial()), (experts, Shard(1))),
                   (alike, on((split, Shard(0)))), mesh)(top_idx, x)
    xe = xe.redistribute(mesh, on((experts, Shard(1)), (kept, Shard(3))))
    hi = local_map(lambda xl, wl: torch.einsum("gecd,ednf->gecnf", xl, wl.to(xl.dtype)),
                   on((experts, Shard(1)), (kept, Partial())),
                   (xe.placements, on((experts, Shard(0)), (kept, Shard(1)))), mesh)(xe, wi)
    hi = reduce_partials(hi)

    def expert_out(hl, wl):
        h = F.silu(hl[..., 0, :].float()).to(hl.dtype) * hl[..., 1, :]
        return torch.einsum("gecf,efd->gecd", h, wl.to(hl.dtype))

    ye_pl = on((experts, Shard(1)), (kept, Shard(3)))
    ye = local_map(expert_out, ye_pl, (hi.placements, on((experts, Shard(0)), (kept, Shard(2)))),
                   mesh)(hi, wo)

    def combine(yel, idx, vals):
        comb, groups = slots(idx, vals, rows)
        y = torch.einsum("gecd,gsec->gsd", yel[groups], comb.to(yel.dtype))
        return y.reshape(-1, s, y.shape[-1])

    y = local_map(combine, on((rows, Shard(0)), (kept, Shard(2)), (experts, Partial())),
                  (ye_pl, alike, alike), mesh)(ye, top_idx, top_vals)
    y = y.redistribute(mesh, on((split, Shard(0)), (experts, Partial())))
    tok, prob = reduce_partials(tok), reduce_partials(prob)
    aux = e * ((tok / (b * s)) * (prob / (b * s))).sum() * AUX_LOSS_WEIGHT
    return whole_sequence_grad(y), aux


def moe_flops_per_token(cfg) -> int:
    """Forward matmul FLOPs per token (routing + experts at capacity)."""
    d, f, k, cf = cfg.d_model, cfg.d_ff, cfg.top_k, cfg.capacity_factor
    expert = 2 * k * cf * d * 3 * f
    dispatch = 2 * 2 * (cfg.moe_group_size * k * cf) * d
    router = 2 * d * cfg.num_experts
    return int(expert + dispatch + router)
