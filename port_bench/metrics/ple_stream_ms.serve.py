"""A request's stream milliseconds across the PLE extraction network:
between the CUDA event pair of each of the program's ``ple`` spans
(``PLEModel``'s levels: every bank, gate and combine, and the stream's
idle time between them) in the traced stretch, over the stretch's
``serve.request`` spans.  None where the spans hold no events (the CPU)
or the program keeps no ``ple`` span."""
import harness


def read(ctx):
    return harness.metric_reader("request_host_ms.serve").per_request(
        ctx, "ple", "stream_ms")
