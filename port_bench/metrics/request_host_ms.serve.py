"""A request's host milliseconds in the port's serving front end: the
host time of the program's ``serve.request`` spans (``build_scorer``'s
scorer, the whole call) in the traced stretch, over their count.  The
other span readers share :func:`per_request`.  Nothing to read (None)
where the program keeps no spans (no ``span_report``) or kept none."""


def span_report(t0_ns=None, t1_ns=None):
    """The program's ``span_report`` of the window, or None where the
    program has none."""
    from rec_now_tpu_torch.core import profiling
    report = getattr(profiling, "span_report", None)
    return None if report is None else report(t0_ns, t1_ns)


def per_request(ctx, name: str, field: str):
    """``field`` of the spans ``name`` in the stretch ``[t0, t0 +
    wall_s]`` (the host's ``perf_counter``, whose nanoseconds the spans
    keep), over the stretch's ``serve.request`` spans."""
    t0, wall = ctx.get("t0"), ctx.get("wall_s")
    if t0 is None or not wall:
        return None
    rep = span_report(int(t0 * 1e9), int((t0 + wall) * 1e9))
    if rep is None:
        return None
    spans = rep["spans"]
    n = spans.get("serve.request", {}).get("count", 0)
    if not n or field not in spans.get(name, {}):
        return None
    return spans[name][field] / n


def read(ctx):
    return per_request(ctx, "serve.request", "host_ms")
