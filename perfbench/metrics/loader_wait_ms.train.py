"""loader_wait_ms.train: the host time the window spent in ``next(loader)``
of the port's ``ShardedLoader``, mean a step (the benchmark's span)."""


def read(ctx):
    waits = ctx.window["spans"].get("loader_wait")
    if ctx.kind != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
