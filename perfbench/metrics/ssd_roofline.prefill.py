"""ssd_roofline.prefill: the least time of the traced stretch's SSD scans
(``roofline/ssd.py``, from each call's shapes) over the device time of the
scan's three kernels found by name in the trace."""

from perfbench.roofline import ssd

KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_output")


def read(ctx):
    if ctx.kind != "prefill" or ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    calls = [c for b, l in ctx.trace.work for c in ctx.model_flops.ssd_calls(ctx.cfg, b, l)]
    if spent <= 0 or not calls:
        return None
    return 100.0 * sum(ssd.bound_s(*c) for c in calls) / spent
