"""mfu.prefill: the model FLOPs of the window's prefills (``roofline/model_*``:
the matrix products the model needs, causal attention on kept pairs) over
the window's host-clock seconds, as a share of the card's bf16 peak."""

from perfbench.roofline import peaks


def read(ctx):
    if ctx.kind != "prefill":
        return None
    return 100.0 * ctx.window["flops"] / ctx.window["seconds"] / peaks.BF16_FLOPS
