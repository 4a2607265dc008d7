"""A request's stream milliseconds across the CIN layer: between the CUDA
event pair of each of the program's ``cin`` spans (B2's kernels, the
layer's layout copies and concatenation, and the stream's idle time
between them) in the traced stretch, over the stretch's
``serve.request`` spans.  None where the spans hold no events (the
CPU)."""
import harness


def read(ctx):
    return harness.metric_reader("request_host_ms.serve").per_request(
        ctx, "cin", "stream_ms")
