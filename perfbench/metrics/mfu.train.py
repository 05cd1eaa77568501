"""mfu.train: the model FLOPs of the window's train steps (three times the
forward's matrix products; remat's recompute not counted) over the
window's host-clock seconds, as a share of the card's bf16 peak."""

from perfbench.roofline import peaks


def read(ctx):
    if ctx.kind != "train":
        return None
    return 100.0 * ctx.window["flops"] / ctx.window["seconds"] / peaks.BF16_FLOPS
