"""flash_roofline.prefill: the least time of the traced stretch's causal
attention (``roofline/flash.py``, from each call's shapes) over the device
time of the flash-attention kernels found by name in the trace."""

from perfbench.roofline import flash

KERNELS = ("flash_fwd_bf16", "flash_fwd_f32")


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    calls = [c for b, l in ctx.trace.work for c in ctx.model_flops.flash_calls(ctx.cfg, b, l)]
    if spent <= 0 or not calls:
        return None
    return 100.0 * sum(flash.bound_s(*c) for c in calls) / spent
