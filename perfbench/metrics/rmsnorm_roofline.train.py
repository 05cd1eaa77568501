"""rmsnorm_roofline.train: the least time of the RMSNorms the traced steps
need, forward and backward (``roofline/rmsnorm.py``; a recompute under
remat is not needed work), over the device time of the RMSNorm kernels
found by name in the trace."""

from perfbench.roofline import rmsnorm

KERNELS = ("rmsnorm_fwd_kernel", "rmsnorm_bwd_kernel", "rmsnorm_dgain_kernel")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(KERNELS)
    if spent <= 0 or not ctx.trace.work:
        return None
    need = 0.0
    for b, s in ctx.trace.work:
        n, rows, d = ctx.model_flops.norm_rows(ctx.cfg, b, s)
        need += n * (rmsnorm.bound_s(rows, d) + rmsnorm.bound_s(rows, d, backward=True))
    return 100.0 * need / spent
