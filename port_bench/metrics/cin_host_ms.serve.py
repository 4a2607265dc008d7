"""A request's host milliseconds in the CIN layer: the host time of the
program's ``cin`` spans (``CINLayer.forward``: its layout copies, the
concatenation and B2's wrapper and launches) in the traced stretch, over
the stretch's ``serve.request`` spans."""
import harness


def read(ctx):
    return harness.metric_reader("request_host_ms.serve").per_request(
        ctx, "cin", "host_ms")
