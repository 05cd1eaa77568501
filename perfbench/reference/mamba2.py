"""The Mamba-2 language model written out plainly, in float32.

Each of the ``num_layers`` blocks: RMSNorm, then the Mamba-2 mixer (arXiv
2405.21060): projections to z, x, B, C and dt; a depthwise causal
convolution of width ``ssm_conv`` and SiLU on x, B and C; dt = softplus(dt
+ dt_bias), A = -exp(a_log); the SSD scan with one group of B and C shared
by all heads; the skip D x; y * silu(z) normalised by RMSNorm; the output
projection; added to the residual stream. A final RMSNorm and the tied
embedding give the logits over ``vocab_size`` columns.

The scan is the chunked state-space-dual form of the paper's minimal
version: within a chunk the masked decay matrix times C Bᵀ, between chunks
the state recurrence over the chunks' total decays, all in one pass of
products (no loop over positions or chunks).

``layout`` names each weight as the program under test names its
parameters. ``prefill`` yields each layer's cache (the final state (B, H,
N, P) and the last ``ssm_conv - 1`` positions of the raw x, B and C
projections) and then the last position's logits; ``loss`` is the mean
next-token cross-entropy, differentiable, with each block recomputed in
the backward pass (``torch.utils.checkpoint``) so that a long batch fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import cross_entropy, mm, prod, rmsnorm

_MIXER = ("in_z", "in_x", "in_b", "in_c", "in_dt", "conv_x", "conv_b", "conv_c",
          "conv_bias_x", "conv_bias_b", "conv_bias_c", "a_log", "d_skip", "dt_bias",
          "norm_scale", "out")


def dims(cfg):
    di = cfg["ssm_expand"] * cfg["d_model"]
    return cfg["d_model"], di, cfg["ssm_state"], di // cfg["ssm_head_dim"], cfg["ssm_head_dim"]


def layout(cfg):
    """[(name, shape, kind, mean, std)]: kind "model" is stored in the
    configuration's dtype, "fp32" in float32. a_log ~ N(2.1, 0.7) and
    dt_bias ~ N(-4.6, 1.33) have the mean and spread of Mamba-2's own
    initialisation (A uniform over [1, 16], softplus(dt_bias) log-uniform
    over [0.001, 0.1])."""
    d, di, n, h, _ = dims(cfg)
    w = cfg["ssm_conv"]
    vp = -(-cfg["vocab_size"] // 256) * 256
    out = [("embed.table", (vp, d), "model", 0.0, 0.02)]
    shapes = {"in_z": ((d, di), "model", 0.0, 1 / math.sqrt(d)),
              "in_x": ((d, di), "model", 0.0, 1 / math.sqrt(d)),
              "in_b": ((d, n), "model", 0.0, 1 / math.sqrt(d)),
              "in_c": ((d, n), "model", 0.0, 1 / math.sqrt(d)),
              "in_dt": ((d, h), "model", 0.0, 1 / math.sqrt(d)),
              "conv_x": ((w, di), "model", 0.0, 0.5),
              "conv_b": ((w, n), "model", 0.0, 0.5),
              "conv_c": ((w, n), "model", 0.0, 0.5),
              "conv_bias_x": ((di,), "model", 0.0, 0.1),
              "conv_bias_b": ((n,), "model", 0.0, 0.1),
              "conv_bias_c": ((n,), "model", 0.0, 0.1),
              "a_log": ((h,), "fp32", 2.1, 0.7),
              "d_skip": ((h,), "fp32", 1.0, 0.1),
              "dt_bias": ((h,), "fp32", -4.6, 1.33),
              "norm_scale": ((di,), "fp32", 1.0, 0.1),
              "out": ((di, d), "model", 0.0, 1 / math.sqrt(di))}
    for i in range(cfg["num_layers"]):
        out.append((f"layers.{i}.norm1.scale", (d,), "fp32", 1.0, 0.1))
        out += [(f"layers.{i}.mixer.{k}",) + shapes[k] for k in _MIXER]
    out.append(("final_norm.scale", (d,), "fp32", 1.0, 0.1))
    return out


def _conv(x, w, b):
    """Depthwise causal convolution: x (B, L, C), w (W, C), b (C,)."""
    width = w.shape[0]
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))
    return F.conv1d(xt, w.t()[:, None, :], b, groups=x.shape[-1]).transpose(1, 2)


def _segsum(a):
    """a (..., T) -> (..., T, T): sum of a[j+1..i] below the diagonal, 0 on
    it, -inf above."""
    t = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    mask = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~mask, float("-inf"))


def ssd(xdt, a, bm, cm, chunk: int, prec: str):
    """The SSD scan from a zero state: xdt (B, L, H, P) the inputs times dt,
    a (B, L, H) = dt * A, bm/cm (B, L, N). Returns y (B, L, H, P) and the
    final state (B, H, N, P)."""
    b, l, h, p = xdt.shape
    n = bm.shape[-1]
    qlen = min(chunk, l)
    pad = -l % qlen
    if pad:  # zeros add nothing to the outputs or the state, and decay by 1
        xdt, a, bm, cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (xdt, a, bm, cm))
    nc = xdt.shape[1] // qlen
    x = xdt.reshape(b, nc, qlen, h, p)
    a = a.reshape(b, nc, qlen, h).permute(0, 3, 1, 2)  # (B, H, C, Q)
    bc = bm.reshape(b, nc, qlen, n)
    cc = cm.reshape(b, nc, qlen, n)
    cum = torch.cumsum(a, dim=-1)
    # within each chunk: y_t = sum_s<=t (C_t . B_s) exp(a_{s+1..t}) x_s
    cb = prod("bcln,bcsn->bcls", cc, bc, prec)
    g = cb[:, None] * torch.exp(_segsum(a))  # (B, H, C, Q, Q)
    y = prod("bhcls,bcshp->bclhp", g, x, prec)
    # each chunk's own state, then the states entering each chunk
    to_end = torch.exp(cum[..., -1:] - cum)  # (B, H, C, Q)
    own = prod("bcsn,bcshp->bchnp", bc, x * to_end.permute(0, 2, 3, 1)[..., None], prec)
    own = torch.cat([torch.zeros_like(own[:, :1]), own], dim=1)  # (B, C+1, H, N, P)
    between = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))  # (B, H, C+1, C+1)
    states = prod("bhzc,bchnp->bzhnp", between, own, prec)
    entering, final = states[:, :-1], states[:, -1]
    y = y + prod("bcln,bchnp->bclhp", cc, entering, prec) * torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, nc * qlen, h, p)[:, :l], final


def _mixer(x, lw, cfg, prec: str):
    """One block's mixer on the normalised input x (B, L, D); lw(name) gives
    the block's weight in float32. Returns (y (B, L, D), cache)."""
    _, di, n, h, p = dims(cfg)
    b, l, _ = x.shape
    z = mm(x, lw("in_z"), prec)
    xr = mm(x, lw("in_x"), prec)
    br = mm(x, lw("in_b"), prec)
    cr = mm(x, lw("in_c"), prec)
    dtr = mm(x, lw("in_dt"), prec)
    keep = cfg["ssm_conv"] - 1
    cache = {"conv_x": xr[:, l - keep:], "conv_b": br[:, l - keep:], "conv_c": cr[:, l - keep:]}
    xc = F.silu(_conv(xr, lw("conv_x"), lw("conv_bias_x")))
    bc = F.silu(_conv(br, lw("conv_b"), lw("conv_bias_b")))
    cc = F.silu(_conv(cr, lw("conv_c"), lw("conv_bias_c")))
    dt = F.softplus(dtr + lw("dt_bias"))
    xh = xc.view(b, l, h, p)
    y, state = ssd(xh * dt[..., None], dt * -torch.exp(lw("a_log")), bc, cc, cfg["ssm_chunk"],
                   prec)
    cache["state"] = state
    y = (y + lw("d_skip")[:, None] * xh).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), lw("norm_scale"), cfg["norm_eps"])
    return mm(y, lw("out"), prec), cache


def _layer_weights(w, i: int):
    def lw(name):
        return w[f"layers.{i}.mixer.{name}"].float()
    return lw


def prefill(w, cfg, tokens, prec: str = "fp32"):
    """Yield ("layer", i, {"state", "conv_x", "conv_b", "conv_c"}) for each
    layer, then ("logits", logits (B, vocab_size)) of the last position."""
    eps = cfg["norm_eps"]
    x = F.embedding(tokens.long(), w["embed.table"]).float()
    for i in range(cfg["num_layers"]):
        hn = rmsnorm(x, w[f"layers.{i}.norm1.scale"].float(), eps)
        y, cache = _mixer(hn, _layer_weights(w, i), cfg, prec)
        yield "layer", i, cache
        x = x + y
        del hn, y, cache
    last = rmsnorm(x[:, -1], w["final_norm.scale"].float(), eps)
    table = w["embed.table"][:cfg["vocab_size"]].float()
    yield "logits", None, mm(last, table.t(), prec)


def _block(x, norm, lws, cfg, prec):
    return x + _mixer(rmsnorm(x, norm, cfg["norm_eps"]), lambda k: lws[k], cfg, prec)[0]


def loss(params, cfg, tokens, labels, prec: str = "fp32"):
    """Mean next-token cross-entropy over tokens (B, S) and labels (B, S);
    ``params`` maps layout names to float32 tensors (leaves of autograd)."""
    x = F.embedding(tokens.long(), params["embed.table"])
    for i in range(cfg["num_layers"]):
        lws = {k: params[f"layers.{i}.mixer.{k}"] for k in _MIXER}
        x = checkpoint(_block, x, params[f"layers.{i}.norm1.scale"], lws, cfg, prec,
                       use_reentrant=False)
    x = rmsnorm(x, params["final_norm.scale"], cfg["norm_eps"])
    logits = mm(x, params["embed.table"][:cfg["vocab_size"]].t(), prec)
    return cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
