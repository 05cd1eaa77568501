"""The SSD scan's least time on the card, from its shapes (b, l, h, p, n,
chunk): C Bᵀ over the causal pairs of each chunk once per batch row (B and
C are shared by the heads); per head the causal G x, C_t . S_prev (every
chunk after the first) and the chunk states. Every product's operands are
the inputs' dtype with the decay folded in, as Mamba-2's own kernels run
them on tensor cores with float32 accumulation, so all of them count at
that dtype's peak (bf16: the tensor cores; float32: the FMA units),
against x and y, B, C, dt, A and the final state moved once at the HBM
rate; whichever is longer. The same count is the scan's model FLOPs."""

from perfbench.roofline import peaks


def _sizes(l: int, chunk: int):
    q = min(chunk, l)
    return [min(q, l - c0) for c0 in range(0, l, q)]


def flop_split(b: int, l: int, h: int, p: int, n: int, chunk: int):
    """(C Bᵀ FLOPs, decay-weighted FLOPs)."""
    sizes = _sizes(l, chunk)
    pairs = sum(m * (m + 1) // 2 for m in sizes)
    cb = 2.0 * b * pairs * n
    weighted = 2.0 * b * h * (pairs * p + (2 * l - sizes[0]) * n * p)
    return cb, weighted


def flops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> float:
    return sum(flop_split(b, l, h, p, n, chunk))


def bound_s(b: int, l: int, h: int, p: int, n: int, chunk: int, dtype_bytes: int = 2) -> float:
    peak = peaks.BF16_FLOPS if dtype_bytes == 2 else peaks.FP32_FLOPS
    nbytes = (dtype_bytes * (2 * b * l * h * p + 2 * b * l * n)
              + 4.0 * (b * l * h + h + b * h * n * p))
    return max(flops(b, l, h, p, n, chunk) / peak, nbytes / peaks.HBM_BYTES_S)
