"""Share of its roofline of one wrapper's kernels, ``multi_dense_fused``
(B8's expert banks), in %: the least seconds of its recorded calls
(``bounds/multi_dense_fused.py``) over the device seconds of its kernels
(``kernels/``).  Nothing to read (None) where none of them ran."""

WRAPPER = "multi_dense_fused"


def read(ctx):
    trace, bound = ctx.get("trace"), ctx.get("bound_s") or {}
    if not trace or WRAPPER not in bound:
        return None
    spent = trace["wrapper_s"].get(WRAPPER, 0.0)
    return 100.0 * bound[WRAPPER] / spent if spent > 0 else None
