"""Share of its roofline of one wrapper's kernels, ``gather_pool_rows``
(the pooled multi-hot lookup), in %: the least seconds of its recorded
calls (``bounds/gather_pool_rows.py``) over the device seconds of its
kernels (``kernels/``).  Nothing to read (None) where none of them
ran."""

WRAPPER = "gather_pool_rows"


def read(ctx):
    trace, bound = ctx.get("trace"), ctx.get("bound_s") or {}
    if not trace or WRAPPER not in bound:
        return None
    spent = trace["wrapper_s"].get(WRAPPER, 0.0)
    return 100.0 * bound[WRAPPER] / spent if spent > 0 else None
