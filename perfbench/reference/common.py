"""Plain PyTorch pieces of the reference models, in float32.

Nothing here imports the program under test. Every matrix product goes
through ``mm`` or ``prod`` so that one switch, ``prec``, computes the whole
model either in float32 (the reference) or with every product's operands
rounded to float8 e4m3 (the control: the precision one step below the
configurations' bfloat16).
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("fp32", "fp8")
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _round_fp8(x):
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32."""
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).float() * scale


class _Fp8(torch.autograd.Function):
    """The rounding as an operand of a product: forward rounds the value,
    backward rounds the gradient that reaches it."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def q(x, prec: str):
    """An operand of a product in the precision ``prec``."""
    if prec == "fp32":
        return x
    if prec == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision {prec!r} not in {PRECISIONS}")


def mm(a, b, prec: str):
    """``a @ b`` in ``prec`` (float32 accumulation)."""
    return q(a, prec) @ q(b, prec)


def prod(eq: str, a, b, prec: str):
    """``einsum(eq, a, b)`` in ``prec``."""
    return torch.einsum(eq, q(a, prec), q(b, prec))


def rmsnorm(x, gain, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope_half(x, positions, theta: float):
    """Rotary embedding of the first half of each head's dims, x (B, L, H, d):
    dims i and i + d/4 of that half form a pair, rotated by position times
    theta ** (-4 i / d); the second half passes through."""
    d = x.shape[-1]
    rd = d // 2
    half = rd // 2
    inv = theta ** (-torch.arange(0, half, device=x.device, dtype=torch.float32) * 2.0 / rd)
    ang = positions[:, None].float() * inv[None, :]  # (L, half)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :half], x[..., half:rd]
    return torch.cat([a * cos - b * sin, b * cos + a * sin, x[..., rd:]], dim=-1)


def cross_entropy(logits, labels):
    """Mean token cross-entropy of logits (N, V) against labels (N,)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - gold).mean()


def attention_scale(d: int) -> float:
    return 1.0 / math.sqrt(d)
