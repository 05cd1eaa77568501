"""Grouped-query attention: full-sequence (training, prefill) and KV-cache
decode paths.

Port of ``repro.models.attention``: causal and non-causal self-attention,
and cross-attention to a modality memory (no mask, no RoPE, the plain
``dot_attention`` as in the reference). Projection kernels keep the
reference's flattened layout, ``wq (D, H*hd)``, ``wk/wv (D, KV*hd)``,
``wo (H*hd, D)``; activations are reshaped to (B,S,H,hd). The causal path
hands GQA K/V with their KV heads to the kernel, which reads them grouped;
the plain path broadcasts them to the full head count. The cache stores only
the KV heads.

The full-sequence causal path runs through either the plain PyTorch
implementation (the reference's ``"xla"``) or the hand-written CUDA
flash-attention kernel (the reference's ``"pallas"``). By default the kernel
takes tensors on the card and the plain path tensors on the CPU;
``set_attention_impl`` pins one of them.

``shard`` is the model's sharder hook (``distributed.sharding.make_sharder``),
constraining q/k/v, the context and the decode scores at the reference's
points; with a sharder the plain path takes K/V expanded to the full heads,
as the reference constrains them. Without one nothing changes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import (constrain, local_map, reduce_partials,
                                              sequence_split_product, shard_index, split_idle,
                                              split_like_weight, split_ready,
                                              split_ready_grad, whole_dim,
                                              whole_sequence_grad)
from repro_torch.models.module import spec
from repro_torch.models.switch import ImplSwitch

_SWITCH = ImplSwitch("attention")  # None: the kernel on the card, plain on the CPU


def set_attention_impl(impl: Optional[str]) -> None:
    """Pin the causal path to ``"plain"`` or ``"cuda"``; ``None`` restores the
    default choice by device."""
    _SWITCH.set(impl)


def get_attention_impl() -> Optional[str]:
    """The impl in force in the calling thread (``models.api.use_impls`` pins
    it there alone)."""
    return _SWITCH.get()


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_spec(cfg):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": spec((d, h * hd), ("embed", "heads_flat")),
        "wk": spec((d, kv * hd), ("embed", "kv_flat")),
        "wv": spec((d, kv * hd), ("embed", "kv_flat")),
        "wo": spec((h * hd, d), ("heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = spec((h * hd,), ("heads_flat",), "zeros")
        p["bk"] = spec((kv * hd,), ("kv_flat",), "zeros")
        p["bv"] = spec((kv * hd,), ("kv_flat",), "zeros")
    return p


def _heads(cfg):
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def _project_q(p, cfg, x):
    h, _, hd = _heads(cfg)
    q = sequence_split_product(x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return split_ready(q, -1, h).reshape(x.shape[0], x.shape[1], h, hd)


def _project_kv(p, cfg, src, dtype):
    _, kv, hd = _heads(cfg)
    k = sequence_split_product(src, p["wk"].to(dtype))
    v = sequence_split_product(src, p["wv"].to(dtype))
    if "bk" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    shp = (src.shape[0], src.shape[1], kv, hd)
    return split_ready(k, -1, kv).reshape(shp), split_ready(v, -1, kv).reshape(shp)


def _out_proj(p, ctx, dtype):
    b, s, h = ctx.shape[:3]
    wo = p["wo"].to(dtype)
    flat = split_like_weight(split_ready_grad(ctx.reshape(b, s, -1), h), wo)
    return whole_sequence_grad(sequence_split_product(flat, wo))


def _expand_kv(k, h: int):
    """(B,S,KV,hd) -> (B,S,H,hd) by broadcasting each KV head over its group."""
    b, s, kv, hd = k.shape
    if kv == h:
        return k
    return k[:, :, :, None, :].expand(b, s, kv, h // kv, hd).reshape(b, s, h, hd)


# ---------------------------------------------------------------------------
# Core attention math (plain path); all tensors (B,S,H,hd) with full heads
# ---------------------------------------------------------------------------


def _softmax(x):
    # Max-subtracted softmax in x's dtype, written out as the reference's
    # jax.nn.softmax computes it, so bf16 statistics stay bf16. On a DTensor
    # split over the last dim (a decode step's scores over the cache's
    # sequence blocks) each statistic is reduced over the ranks where it is
    # made, and the scores keep their split
    e = torch.exp(x - reduce_partials(x.amax(-1, keepdim=True)))
    return e / reduce_partials(e.sum(-1, keepdim=True))


def _stat_consts(hd: int, stat: torch.dtype):
    """The score scale and mask value as the reference has them in ``stat``
    (rounded to bf16 for bf16), as Python floats: a scalar tensor built on
    the card would cost a host-to-device copy that stalls the host."""
    scale = torch.tensor(hd ** -0.5, dtype=stat).item()
    return scale, (-1e30 if stat == torch.float32 else -3e38 / 4)


def dot_attention(q, k, v, mask=None):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd). mask broadcastable (B,1,Sq,Sk).

    fp32 softmax for fp32 inputs. For bf16 inputs the scores and the softmax
    statistics stay in bf16, as in the reference's plain path; the kernel
    keeps fp32 statistics instead, so it is held against ``attention_ref``.
    """
    if _is_dtensor(q) and mask is None:
        return _per_shard(dot_attention, q, k, v)
    hd = q.shape[-1]
    stat = torch.float32 if q.dtype == torch.float32 else q.dtype
    scale, neg = _stat_consts(hd, stat)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).to(stat) * scale
    if mask is not None:
        scores = torch.where(mask, scores, neg)
    probs = _softmax(scores).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


# Above this many key tokens the plain path walks q-blocks, so the Sq x Sk
# score tensor is never materialised (peak: block_q x Sk per head).
CHUNK_THRESHOLD = 4096
CHUNK_Q = 512


def _use_kernel(q) -> bool:
    return _SWITCH.use_kernel(q)


def _per_shard(fn, q, k, v, *rest, causal: bool = False):
    """``fn(q, k, v, *rest)`` on DTensors, run on each rank's batch and head
    shards (``local_map``): attention is independent across batch rows and
    heads, and DTensor cannot multiply a batch and a head split over two mesh
    dims once they merge into one. K/V are expanded to the query heads
    first; the sequence and head dims are made whole. A mesh dim that splits
    neither the rows nor the heads splits the heads where they divide it
    (``split_idle``: the model axis under "dp" for a microbatch of fewer rows
    than ranks, or under "sp" where the heads were made whole; from q's
    sequence split an all-to-all), else the query's sequence against whole
    K/V (14 heads over 16 ranks), as GSPMD divides both; the region then
    takes the rank's first query position as ``q_offset`` where ``causal``.
    The context goes back to q's layout there."""
    from torch.distributed.tensor import Replicate

    h, mesh = q.shape[2], q.device_mesh
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    pls = split_idle(q, 2, spill=1)
    rows = [i for i, p in enumerate(pls) if p.is_shard(1)]
    kv = [Replicate() if p.is_shard(1) else p for p in pls]
    region = fn
    if rows and causal:
        def region(ql, kl, vl, *r):
            return fn(ql, kl, vl, *r, q_offset=shard_index(mesh, rows) * ql.shape[1])
    ctx = local_map(region, pls, (pls, kv, kv) + (None,) * len(rest), mesh)(q, k, v, *rest)
    # where the heads or the queries were split for the region alone, the
    # context goes back to q's layout (from its sequence split, an all-to-all
    # each way)
    back = [p if p == pq or not (p.is_shard(2) or p.is_shard(1)) else
            pq if pq.is_shard() else Replicate() for p, pq in zip(pls, q.placements)]
    return ctx if back == pls else ctx.redistribute(mesh, back)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def causal_attention(q, k, v, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) with KV dividing H. The kernel reads
    grouped K/V as they are; the plain path expands them to H heads first.
    ``q_offset`` is the first query's position among the keys (a rank's
    block of the queries, ``_per_shard``)."""
    if _is_dtensor(q):
        return _per_shard(causal_attention, q, k, v, causal=True)
    if _use_kernel(q):
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    k, v = (_expand_kv(t, q.shape[2]) for t in (k, v))
    sq, sk = q.shape[1], k.shape[1]
    if sk > CHUNK_THRESHOLD and sq % CHUNK_Q == 0:
        return _chunked_causal_attention(q, k, v, CHUNK_Q, q_offset)
    mask = (torch.arange(sk, device=q.device)[None, :]
            <= q_offset + torch.arange(sq, device=q.device)[:, None])[None, None]
    return dot_attention(q, k, v, mask)


def _chunked_causal_attention(q, k, v, block_q: int, q_offset: int = 0):
    sq, sk = q.shape[1], k.shape[1]
    cols = torch.arange(sk, device=q.device)[None, :]
    out = []
    for offs in range(0, sq, block_q):
        rows = q_offset + offs + torch.arange(block_q, device=q.device)[:, None]
        out.append(dot_attention(q[:, offs:offs + block_q], k, v, (cols <= rows)[None, None]))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------


def apply_self_attn(p, cfg, x, positions, causal=True, shard=None):
    """Full-sequence self-attention. Returns (y, (k_cache, v_cache))."""
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x, x.dtype)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)
    kc, vc = k, v
    if shard is not None:
        q = constrain(shard, "acts_qkv", q)
        k, v = _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads)
        sq = q.shape[1]
        # long sequences: K/V replicated over model before the q-block walk
        name = ("acts_kv_repl" if sq > CHUNK_THRESHOLD and sq % CHUNK_Q == 0
                else "acts_qkv")
        k, v = constrain(shard, name, k), constrain(shard, name, v)
    if causal:
        ctx = causal_attention(q, k, v)  # expands K/V only on the plain path
    else:
        ctx = dot_attention(q, _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads))
    ctx = constrain(shard, "acts_qkv", ctx)
    return _out_proj(p, ctx, x.dtype), (kc, vc)


def apply_cross_attn(p, cfg, x, memory):
    """Cross-attention to (B,M,D) memory (no mask, no RoPE). Returns
    (y, (k, v)), k/v (B,M,KV,hd) from the memory."""
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, memory, x.dtype)
    ctx = dot_attention(q, _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads))
    return _out_proj(p, ctx, x.dtype), (k, v)


def decode_self_attn(p, cfg, x_t, cache, pos, shard=None):
    """One-token decode. x_t (B,1,D); cache {"k","v"} (B,Smax,KV,hd);
    pos (B,) positions (attention masks per request).

    As in the reference, the cache write is a masked select at the
    batch-synchronised step offset ``pos[0]`` (no write at all when
    ``pos[0]`` lies outside the cache), it returns a new cache rather than
    writing in place, and the scores stay grouped by KV head instead of
    expanding the cache to full heads.
    """
    q = _project_q(p, cfg, x_t)
    k_t, v_t = _project_kv(p, cfg, x_t, x_t.dtype)
    q = _apply_rope(cfg, q, pos[:, None])
    k_t = _apply_rope(cfg, k_t, pos[:, None])
    smax = cache["k"].shape[1]
    k = _cache_write(cache["k"], k_t, pos)
    v = _cache_write(cache["v"], v_t, pos)
    b = q.shape[0]
    h, kv, hd = _heads(cfg)
    # on a mesh the query's heads are made whole: the cache splits its
    # sequence (the flash-decoding split), and a head split beside a batch
    # split would merge into one DTensor cannot multiply
    q5 = whole_dim(q, 2).reshape(b, 1, kv, h // kv, hd)
    sub = _idle_split(k, q5)
    ar = _read_order(smax, k, sub, x_t.device)
    mask = (ar[None, :] <= pos[:, None])[:, None, None, None, :]
    stat = torch.float32 if q.dtype == torch.float32 else q.dtype
    scale, neg = _stat_consts(hd, stat)
    scores = _cache_product("bqkgd,bskd->bkgqs", q5, k.to(q.dtype), sub).to(stat)
    if not sub:  # the reference's constraint would gather a further split
        scores = constrain(shard, "decode_scores5", scores)
    probs = _softmax(torch.where(mask, scores * scale, neg)).to(q.dtype)
    ctx = _cache_product("bkgqs,bskd->bqkgd", probs, v.to(q.dtype), sub)
    ctx = ctx.reshape(b, 1, h, hd)
    return _out_proj(p, ctx, x_t.dtype), {"k": k, "v": v}


def _write(cache, new, pos, first: int = 0):
    """``new``'s first position written into ``cache`` at ``pos[0]``
    (``first``: the cache's first position held)."""
    ar = first + torch.arange(cache.shape[1], device=cache.device)
    sel = (ar == pos[0])[None, :, None, None]
    return torch.where(sel, new.to(cache.dtype)[:, :1], cache)


def _cache_write(cache, new, pos):
    """The decode step's masked write into the cache (B, S, KV, hd). On a
    DTensor each rank writes its own rows and block of the sequence
    (``local_map``), and the cache keeps its layout: DTensor's own select
    may gather the cache's sequence to meet the one new position (2 GiB a
    layer on moonshot-v1-16b-a3b's decode cell), and then every rank of the
    sequence split runs all of the cache's products."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dtensor(cache):
        return _write(cache, new, pos)
    mesh = cache.device_mesh
    pls = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in cache.placements]
    seq = [i for i, p in enumerate(pls) if p.is_shard(1)]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pls]

    def write(c, n, ps):
        return _write(c, n, ps, shard_index(mesh, seq) * c.shape[1])

    whole = [Replicate()] * mesh.ndim
    return local_map(write, pls, (pls, rows, whole), mesh)(cache, new, pos)


def _idle_split(kv, q):
    """The mesh dims over which a decode step reads each rank's block of the
    cache ``kv`` (B, S, KV, hd) in parts: those of more than one rank that
    split neither the step's rows (``q``'s dim 0) nor the cache's rows or
    sequence, in mesh order, while the block still divides evenly (a batch
    of one row leaves "data" so, and "pod"). Each rank of such a dim reads
    its part of the block, as GSPMD splits the reads, where it would read
    all of it alike; the scores' statistics and the context are then
    reduced over these dims too. [] off a mesh."""
    if not _is_dtensor(kv):
        return []
    mesh = kv.device_mesh
    seq = [i for i, p in enumerate(kv.placements) if p.is_shard(1)]
    block = kv.shape[1] // math.prod(mesh.size(i) for i in seq)
    out, n = [], 1
    for i, (pk, pq) in enumerate(zip(kv.placements, q.placements)):
        if mesh.size(i) > 1 and not (pk.is_shard(0) or pk.is_shard(1)) \
                and not (pq.is_shard() and pq.dim % q.ndim == 0) \
                and block % (n * mesh.size(i)) == 0:
            out.append(i)
            n *= mesh.size(i)
    return out


def _read_order(smax: int, kv, sub, device):
    """The cache positions in the order of a decode step's scores: ``arange``
    where nothing splits the reads further (``_idle_split``); else the order
    in which the scores, split over the sequence's and the idle dims in mesh
    order, hold them: rank r of an idle dim reads the r-th part of its
    sequence block, which is not the r-th part of the whole sequence."""
    ar = torch.arange(smax, device=device)
    if not sub:
        return ar
    mesh = kv.device_mesh
    seq = [i for i, p in enumerate(kv.placements) if p.is_shard(1)]
    dims = seq + sub
    held = ar.reshape(*(mesh.size(i) for i in dims), -1)  # axes: sequence blocks, parts, position
    order = sorted(range(len(dims)), key=dims.__getitem__)
    return held.permute(*order, len(dims)).reshape(smax)


def _cache_product(eq: str, a, kv, sub=()):
    """``einsum(eq, a, kv)`` of a decode step's grouped scores (``a`` the
    query) or context (``a`` the probabilities) with the cache's K or V
    (B, S, KV, hd). On DTensors it runs on each rank's rows and its block of
    the cache's sequence (``local_map``: the flash-decoding split GSPMD
    makes), the scores split over the sequence there and the context a sum
    over those ranks: DTensor's own einsum may move the cache's split to its
    KV heads (16 of them over 16 ranks) and then refuse to merge them with
    the batch for the product. Each rank of the mesh dims ``sub``
    (``_idle_split``) reads its part of the block, a local slice: the
    scores are split there too, in ``_read_order``, and the context summed."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not _is_dtensor(kv):
        return torch.einsum(eq, a, kv)
    mesh = kv.device_mesh
    pls = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in kv.placements]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pls]
    split = [p.is_shard(1) or i in sub for i, p in enumerate(pls)]
    seq = [Shard(0) if p.is_shard(0) else Shard(4) if s else Replicate()
           for p, s in zip(pls, split)]
    scores = eq.endswith("qs")
    outs = seq if scores else [Partial() if s else r for s, r in zip(split, rows)]
    part = shard_index(mesh, sub), math.prod(mesh.size(i) for i in sub)

    def product(al, kl):
        if sub:
            n = kl.shape[1] // part[1]
            kl = kl.narrow(1, part[0] * n, n)
        return torch.einsum(eq, al, kl)

    y = local_map(product, outs, (rows if scores else seq, pls), mesh)(a, kv)
    return y if scores else reduce_partials(y)


def decode_cross_attn(p, cfg, x_t, cache):
    """One-token cross-attention to the memory's cached K/V; the cache is
    returned as it is."""
    q = _project_q(p, cfg, x_t)
    ctx = dot_attention(q, _expand_kv(cache["k"].to(q.dtype), cfg.num_heads),
                        _expand_kv(cache["v"].to(q.dtype), cfg.num_heads))
    return _out_proj(p, ctx, x_t.dtype), cache


def _apply_rope(cfg, x, positions):
    from repro_torch.models.layers import apply_rope
    return apply_rope(x, positions, cfg.rope_theta, cfg.rope_style)


def kv_cache_shape(cfg, batch: int, seq: int):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": (batch, seq, kv, hd), "v": (batch, seq, kv, hd)}
