"""The device's idle share of the traced stretch, in %: 1 - (the union of
its kernels', copies' and memsets' intervals over the stretch)."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["device_ops"] or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
