"""RMSNorm's least time on the card, from its shapes (rows r, width d):
the forward reads x and the gain and writes y (2 r d elements + 4 d
bytes); the backward reads x, dy and the gain and writes dx and the gain's
gradient (3 r d elements + 8 d bytes); at the HBM rate, against about 4
(forward) or 8 (backward) float32 FLOP an element; whichever is longer."""

from perfbench.roofline import peaks


def bound_s(r: int, d: int, dtype_bytes: int = 2, backward: bool = False) -> float:
    nbytes = (3.0 if backward else 2.0) * r * d * dtype_bytes + (8.0 if backward else 4.0) * d
    flops = (8.0 if backward else 4.0) * r * d
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_S)
