"""engine_host_ms.prefill: the host time inside ``DecodeEngine.prefill``
until it returns (the enqueue of the model's work), mean a request of the
window (the benchmark's span)."""


def read(ctx):
    spans = ctx.window["spans"].get("engine_host")
    if ctx.kind != "prefill" or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
