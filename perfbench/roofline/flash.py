"""Causal attention's least time on the card, from its shapes: 4 d FLOP for
each (query, key) pair the causal mask keeps, per query head, at the bf16
peak; or q, k, v and o moved once (K/V read with their KV heads, as the
model stores them) at the HBM rate; whichever is longer. It counts the
work the inputs need, whatever kernel does it."""

from perfbench.roofline import peaks


def pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    """Kept (query, key) pairs: query i sees keys 0..min(i + q_offset, sk - 1)."""
    t = max(0, min(sq, sk - q_offset))  # the queries whose last key lies inside
    return t * (t + 1) // 2 + t * q_offset + (sq - t) * sk


def bound_s(b: int, sq: int, sk: int, heads: int, kv_heads: int, d: int,
            dtype_bytes: int = 2) -> float:
    flops = 4.0 * d * heads * b * pairs(sq, sk)
    nbytes = dtype_bytes * b * d * (2 * sq * heads + 2 * sk * kv_heads)
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)


def flops(b: int, sq: int, heads: int, d: int) -> float:
    """The products of causal attention over one prompt batch (the model
    FLOPs of attention): QKᵀ and PV on the kept pairs."""
    return 4.0 * d * heads * b * pairs(sq, sq)
