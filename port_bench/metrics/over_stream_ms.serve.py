"""A request's stream milliseconds across the over arch: between the CUDA
event pair of each of the program's ``over`` spans
(``DLRMDCNv2Model``'s over-arch MLP: four layers, each one B8 ``wgmma``
launch with its bias and ReLU where the tower routes it there, and the
stream's idle time between them) in the traced stretch, over the
stretch's ``serve.request`` spans.  None where the spans hold no events
(the CPU) or the program keeps no ``over`` span."""
import harness


def read(ctx):
    return harness.metric_reader("request_host_ms.serve").per_request(
        ctx, "over", "stream_ms")
