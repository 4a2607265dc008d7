"""Device kernels, copies and memsets in the traced stretch per served
request."""


def read(ctx):
    trace, n = ctx.get("trace"), ctx.get("requests")
    if not trace or not n or not trace["device_ops"]:
        return None
    return trace["device_ops"] / n
