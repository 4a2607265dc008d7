"""A request's stream milliseconds across the low-rank cross stack:
between the CUDA event pair of each of the program's ``cross`` spans
(``DLRMDCNv2Model``'s cross layers: two products and a fused
multiply-add a layer, and the stream's idle time between them) in the
traced stretch, over the stretch's ``serve.request`` spans.  None where
the spans hold no events (the CPU) or the program keeps no ``cross``
span."""
import harness


def read(ctx):
    return harness.metric_reader("request_host_ms.serve").per_request(
        ctx, "cross", "stream_ms")
