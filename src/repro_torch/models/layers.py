"""Shared neural-net layers: norms, RoPE, gated MLP, embeddings.

Port of ``repro.models.layers``. Apply functions take the mapping of
parameters produced from the matching ``*_spec`` (a dict or an
``nn.ParameterDict``). Compute runs in the activation dtype; reductions that
need it (norm statistics, SiLU, loss) run in fp32, as in the reference.
Weights keep the JAX layout (``x @ w``), so carrying them across is slicing.

RMSNorm runs through either the plain PyTorch math (the reference's inline
``apply_norm``) or the hand-written CUDA RMSNorm kernels, forward and
backward (the reference's Pallas ``rmsnorm``, which no model path of the
reference calls). By default the kernels take tensors on the card and the
plain math tensors on the CPU; ``set_norm_impl`` pins one of them. LayerNorm
always runs plain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.module import spec
from repro_torch.models.switch import ImplSwitch

_SWITCH = ImplSwitch("norm")  # None: the kernel on the card, plain on the CPU


def set_norm_impl(impl: Optional[str]) -> None:
    """Pin RMSNorm to ``"plain"`` or ``"cuda"``; ``None`` restores the default
    choice by device."""
    _SWITCH.set(impl)


def get_norm_impl() -> Optional[str]:
    """The impl in force in the calling thread (``models.api.use_impls`` pins
    it there alone)."""
    return _SWITCH.get()


def _use_kernel(x) -> bool:
    return _SWITCH.use_kernel(x)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": spec((d,), ("embed",), "ones", dtype=torch.float32),
                "bias": spec((d,), ("embed",), "zeros", dtype=torch.float32)}
    return {"scale": spec((d,), ("embed",), "ones", dtype=torch.float32)}


def apply_norm(p, x, eps: float = 1e-6):
    if "bias" not in p and _use_kernel(x):
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, p["scale"], eps)
    dt = x.dtype
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # RMSNorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rotary_dims: Optional[int] = None,
                     device=None):
    rd = rotary_dims or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x, positions, theta: float, style: str = "full"):
    """x: (..., S, H, D). positions: broadcastable to (..., S) integer.

    style "full": rotate all D dims (Llama / Qwen / Phi).
    style "2d":   ChatGLM partial rotary, rotating only the first half of the
                  head dims and passing the second half through.
    """
    d = x.shape[-1]
    rd = d // 2 if style == "2d" else d
    inv = rope_frequencies(d, theta, rd, device=x.device)
    ang = positions[..., None].float() * inv  # (..., S, rd//2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, rd//2) broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rot, x[..., rd:].float()], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": spec((d, 2, f), ("embed", None, "mlp")),  # fused gate+up
        "wo": spec((f, d), ("mlp", "embed")),
    }


def apply_mlp(p, x):
    wi = p["wi"].to(x.dtype)
    d, _, f = wi.shape
    gu = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
    g, u = gu[..., 0, :], gu[..., 1, :]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def padded_vocab(v: int) -> int:
    """Vocab rows padded to a multiple of 256, as in the reference (whose
    tables shard evenly on any mesh axis that way)."""
    return -(-v // 256) * 256


def embed_spec(cfg):
    v, d = padded_vocab(cfg.vocab_size), cfg.d_model
    if cfg.tie_embeddings:
        return {"table": spec((v, d), ("vocab", "embed"), "embed", scale=0.02)}
    return {
        "table": spec((v, d), (None, "mlp"), "embed", scale=0.02),
        "unembed": spec((d, v), ("embed", "vocab"), "normal"),
    }


def embed_tokens(p, tokens, dtype):
    return F.embedding(tokens.long(), p["table"]).to(dtype)


def unembed(p, x, softcap: float = 0.0, vocab: int = 0):
    w = p["table"].T if "unembed" not in p else p["unembed"]
    logits = (x @ w.to(x.dtype)).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if vocab and vocab < logits.shape[-1]:
        # mask padded vocab columns out of the softmax
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(pad_mask, logits, -1e30)
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. logits (..., V), labels (...) int."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
