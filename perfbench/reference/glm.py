"""The GLM decoder (ChatGLM3) written out plainly, in float32.

Pre-norm blocks: RMSNorm, grouped-query causal self-attention with biases
on q, k and v and rotary embedding on the first half of each head's dims,
RMSNorm, SwiGLU MLP (gate and up fused in one weight), and an untied
output projection over ``vocab_size`` columns. Query head h reads key and
value head h // (H / KV).

``layout`` names each weight as the program under test names its
parameters, so the benchmark hands one set of tensors to both. ``prefill``
walks the layers of one prompt batch and yields each layer's cache (the
keys after rotary embedding, and the values) and then the last position's
logits; attention runs in blocks of queries so that no full score matrix
of a long prompt is held. ``loss`` is the mean next-token cross-entropy,
differentiable, each layer recomputed in the backward pass
(``torch.utils.checkpoint``) so that a long batch fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import (attention_scale, cross_entropy, mm, prod, rmsnorm,
                                        rope_half)

QUERY_BLOCK = 1024


def layout(cfg):
    """[(name, shape, kind, mean, std)]: kind "model" is stored in the
    configuration's dtype, "fp32" in float32."""
    d, h, kv, hd, f = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                       cfg["head_dim"], cfg["d_ff"])
    vp = -(-cfg["vocab_size"] // 256) * 256
    out = [("embed.table", (vp, d), "model", 0.0, 0.02),
           ("embed.unembed", (d, vp), "model", 0.0, 1 / math.sqrt(d))]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "fp32", 1.0, 0.1),
                (p + "mixer.wq", (d, h * hd), "model", 0.0, 1 / math.sqrt(d)),
                (p + "mixer.wk", (d, kv * hd), "model", 0.0, 1 / math.sqrt(d)),
                (p + "mixer.wv", (d, kv * hd), "model", 0.0, 1 / math.sqrt(d)),
                (p + "mixer.wo", (h * hd, d), "model", 0.0, 1 / math.sqrt(h * hd)),
                (p + "mixer.bq", (h * hd,), "model", 0.0, 0.1),
                (p + "mixer.bk", (kv * hd,), "model", 0.0, 0.1),
                (p + "mixer.bv", (kv * hd,), "model", 0.0, 0.1),
                (p + "norm2.scale", (d,), "fp32", 1.0, 0.1),
                (p + "mlp.wi", (d, 2, f), "model", 0.0, 1 / math.sqrt(d)),
                (p + "mlp.wo", (f, d), "model", 0.0, 1 / math.sqrt(f))]
    out.append(("final_norm.scale", (d,), "fp32", 1.0, 0.1))
    return out


def _attention(qh, k, v, prec: str):
    """Causal attention, qh (B, L, H, d), k/v (B, L, KV, d), in query blocks."""
    b, l, h, d = qh.shape
    kv = k.shape[2]
    g = h // kv
    scale = attention_scale(d)
    keys = torch.arange(l, device=qh.device)
    out = []
    for s in range(0, l, QUERY_BLOCK):
        e = min(l, s + QUERY_BLOCK)
        qb = qh[:, s:e].reshape(b, e - s, kv, g, d)
        scores = prod("bqkgd,bskd->bkgqs", qb, k, prec) * scale
        mask = keys[None, :] <= torch.arange(s, e, device=qh.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out.append(prod("bkgqs,bskd->bqkgd", probs, v, prec).reshape(b, e - s, h, d))
    return torch.cat(out, dim=1)


_LAYER = ("norm1.scale", "mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo", "mixer.bq",
          "mixer.bk", "mixer.bv", "norm2.scale", "mlp.wi", "mlp.wo")


def _qkv(x, lw, cfg, prec: str):
    """The layer's normalised input's rotated queries and keys, and values."""
    h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    b, l, _ = x.shape
    positions = torch.arange(l, device=x.device)
    hn = rmsnorm(x, lw("norm1.scale"), cfg["norm_eps"])
    qh = (mm(hn, lw("mixer.wq"), prec) + lw("mixer.bq")).view(b, l, h, hd)
    k = (mm(hn, lw("mixer.wk"), prec) + lw("mixer.bk")).view(b, l, kv, hd)
    v = (mm(hn, lw("mixer.wv"), prec) + lw("mixer.bv")).view(b, l, kv, hd)
    theta = cfg["rope_theta"]
    return rope_half(qh, positions, theta), rope_half(k, positions, theta), v


def _rest(x, qh, k, v, lw, cfg, prec: str):
    """The layer after its q, k and v: attention, its projection, the MLP."""
    b, l, _ = x.shape
    ctx = _attention(qh, k, v, prec)
    x = x + mm(ctx.reshape(b, l, -1), lw("mixer.wo"), prec)
    hn = rmsnorm(x, lw("norm2.scale"), cfg["norm_eps"])
    wi = lw("mlp.wi")
    gu = mm(hn, wi.reshape(wi.shape[0], -1), prec).view(b, l, 2, -1)
    return x + mm(F.silu(gu[:, :, 0]) * gu[:, :, 1], lw("mlp.wo"), prec)


def prefill(w, cfg, tokens, prec: str = "fp32"):
    """Yield ("layer", i, {"k", "v"}) for each layer, then ("logits", logits
    (B, vocab_size)) of the last position. ``w`` maps a layout name to a
    tensor (any float dtype); tokens (B, L) integer ids."""
    x = F.embedding(tokens.long(), w["embed.table"]).float()
    for i in range(cfg["num_layers"]):
        def lw(name, i=i):
            return w[f"layers.{i}.{name}"].float()
        qh, k, v = _qkv(x, lw, cfg, prec)
        yield "layer", i, {"k": k, "v": v}
        x = _rest(x, qh, k, v, lw, cfg, prec)
        del qh, k, v
    last = rmsnorm(x[:, -1], w["final_norm.scale"].float(), cfg["norm_eps"])
    logits = mm(last, w["embed.unembed"][:, :cfg["vocab_size"]].float(), prec)
    yield "logits", None, logits


def _layer(x, lws, cfg, prec):
    lw = lws.__getitem__
    return _rest(x, *_qkv(x, lw, cfg, prec), lw, cfg, prec)


def loss(params, cfg, tokens, labels, prec: str = "fp32"):
    """Mean next-token cross-entropy over tokens (B, S) and labels (B, S);
    ``params`` maps layout names to float32 tensors (leaves of autograd)."""
    x = F.embedding(tokens.long(), params["embed.table"])
    for i in range(cfg["num_layers"]):
        lws = {k: params[f"layers.{i}.{k}"] for k in _LAYER}
        x = checkpoint(_layer, x, lws, cfg, prec, use_reentrant=False)
    x = rmsnorm(x, params["final_norm.scale"], cfg["norm_eps"])
    logits = mm(x, params["embed.unembed"][:, :cfg["vocab_size"]], prec)
    return cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())

