"""Share of the roofline of the port's own kernels, in %: the least
seconds of every recorded call of a wrapper with a file in ``bounds/``
(``bounds/<wrapper>.py``, at the peaks of ``peaks.json``) over the
device seconds of the kernels that the map in ``kernels/`` gives to
those wrappers.  Nothing to read (None) where no such kernel ran."""


def read(ctx):
    trace, bound = ctx.get("trace"), ctx.get("bound_s") or {}
    if not trace:
        return None
    spent = sum(s for w, s in trace["wrapper_s"].items() if w in bound)
    if spent <= 0:
        return None
    return 100.0 * sum(bound.values()) / spent
