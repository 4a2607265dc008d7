"""Seconds of the run's set-up in the program's own one-time spans: the
first request of each scorer (``serve.first_request``: lazy library
loads, CUDA's lazy module loading, the first allocations) and the
kernel libraries' loads and builds (``kernels.load``, ``kernels.build``)
opened outside any other span.  Nothing to read (None) where the program
keeps no such spans."""
import harness

NAMES = ("serve.first_request", "kernels.load", "kernels.build")


def read(ctx):
    rep = harness.metric_reader("request_host_ms.serve").span_report()
    if rep is None or not any(n in rep["spans"] for n in NAMES):
        return None
    return sum(rep["spans"][n]["top_ms"] for n in NAMES
               if n in rep["spans"]) / 1e3
