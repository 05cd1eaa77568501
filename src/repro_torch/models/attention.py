"""Grouped-query attention: full-sequence (training, prefill) and KV-cache
decode paths.

Port of ``repro.models.attention`` (self-attention only; cross-attention
arrives with the VLM and encoder-decoder slice). Projection kernels keep the
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
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.module import spec

IMPLS = ("plain", "cuda")
_IMPL: Optional[str] = None  # None: the kernel on the card, plain on the CPU


def set_attention_impl(impl: Optional[str]) -> None:
    """Pin the causal path to ``"plain"`` or ``"cuda"``; ``None`` restores the
    default choice by device."""
    global _IMPL
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS} or None")
    _IMPL = impl


def get_attention_impl() -> Optional[str]:
    return _IMPL


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
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q.reshape(x.shape[0], x.shape[1], h, hd)


def _project_kv(p, cfg, src, dtype):
    _, kv, hd = _heads(cfg)
    k = src @ p["wk"].to(dtype)
    v = src @ p["wv"].to(dtype)
    if "bk" in p:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    shp = (src.shape[0], src.shape[1], kv, hd)
    return k.reshape(shp), v.reshape(shp)


def _out_proj(p, ctx, dtype):
    b, s = ctx.shape[:2]
    return ctx.reshape(b, s, -1) @ p["wo"].to(dtype)


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
    # jax.nn.softmax computes it, so bf16 statistics stay bf16.
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


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
    hd = q.shape[-1]
    stat = torch.float32 if q.dtype == torch.float32 else q.dtype
    scale, neg = _stat_consts(hd, stat)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).to(stat) * scale
    if mask is not None:
        scores = torch.where(mask, scores, neg)
    probs = _softmax(scores).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


# Above this many query tokens the plain path walks q-blocks, so the S x S
# score tensor is never materialised (peak: block_q x S per head).
CHUNK_THRESHOLD = 4096
CHUNK_Q = 512


def _use_kernel(q) -> bool:
    if _IMPL == "cuda":
        if not q.is_cuda:
            raise ValueError("attention impl 'cuda' asked for with tensors on "
                             f"{q.device}; the kernel runs on the card only")
        return True
    return _IMPL is None and q.is_cuda


def causal_attention(q, k, v):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) with KV dividing H. The kernel reads
    grouped K/V as they are; the plain path expands them to H heads first."""
    if _use_kernel(q):
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True)
    k, v = (_expand_kv(t, q.shape[2]) for t in (k, v))
    sq, sk = q.shape[1], k.shape[1]
    if sq > CHUNK_THRESHOLD and sq % CHUNK_Q == 0:
        return _chunked_causal_attention(q, k, v, CHUNK_Q)
    mask = (torch.arange(sk, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None])[None, None]
    return dot_attention(q, k, v, mask)


def _chunked_causal_attention(q, k, v, block_q: int):
    sq = q.shape[1]
    cols = torch.arange(sq, device=q.device)[None, :]
    out = []
    for offs in range(0, sq, block_q):
        rows = offs + torch.arange(block_q, device=q.device)[:, None]
        out.append(dot_attention(q[:, offs:offs + block_q], k, v, (cols <= rows)[None, None]))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------


def apply_self_attn(p, cfg, x, positions, causal=True):
    """Full-sequence self-attention. Returns (y, (k_cache, v_cache))."""
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x, x.dtype)
    q = _apply_rope(cfg, q, positions)
    k = _apply_rope(cfg, k, positions)
    if causal:
        ctx = causal_attention(q, k, v)  # expands K/V only on the plain path
    else:
        ctx = dot_attention(q, _expand_kv(k, cfg.num_heads), _expand_kv(v, cfg.num_heads))
    return _out_proj(p, ctx, x.dtype), (k, v)


def decode_self_attn(p, cfg, x_t, cache, pos):
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
    ar = torch.arange(smax, device=x_t.device)
    sel = (ar == pos[0])[None, :, None, None]
    k = torch.where(sel, k_t.to(cache["k"].dtype)[:, :1], cache["k"])
    v = torch.where(sel, v_t.to(cache["v"].dtype)[:, :1], cache["v"])
    mask = (ar[None, :] <= pos[:, None])[:, None, None, None, :]
    b = q.shape[0]
    h, kv, hd = _heads(cfg)
    q5 = q.reshape(b, 1, kv, h // kv, hd)
    stat = torch.float32 if q.dtype == torch.float32 else q.dtype
    scale, neg = _stat_consts(hd, stat)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q5, k.to(q.dtype)).to(stat) * scale
    probs = _softmax(torch.where(mask, scores, neg)).to(q.dtype)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(q.dtype))
    ctx = ctx.reshape(b, 1, h, hd)
    return _out_proj(p, ctx, x_t.dtype), {"k": k, "v": v}


def _apply_rope(cfg, x, positions):
    from repro_torch.models.layers import apply_rope
    return apply_rope(x, positions, cfg.rope_theta, cfg.rope_style)


def kv_cache_shape(cfg, batch: int, seq: int):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": (batch, seq, kv, hd), "v": (batch, seq, kv, hd)}
