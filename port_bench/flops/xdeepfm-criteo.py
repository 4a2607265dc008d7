"""Model operations of ``xdeepfm-criteo`` a request, for the whole
request's share of the peak (``mfu.serve``).

An example, at its D embedding coordinates (M = B D rows): each CIN
layer's least operations (``work.cin_flops``, layer 1 on its F(F+1)/2
symmetric pairs) and its pooling over D; the DNN's and the output unit's
products; the F linear weights summed.
"""
import work


def request_flops(cfg: dict, batch_size: int) -> float:
    f, d = cfg["num_fields"], cfg["embedding_dim"]
    k, m = cfg["cin_layer_size"], batch_size * d
    cin, h = 0, f
    for i in range(cfg["cin_layers"]):
        cin += work.cin_flops(m, f, h, k, i == 0) + m * k
        h = k
    dnn, prev = 0, f * d
    for _ in range(cfg["dnn_layers"]):
        dnn += 2 * prev * cfg["dnn_layer_size"]
        prev = cfg["dnn_layer_size"]
    head = 2 * (cfg["cin_layers"] * k + prev) + f
    return float(cin + (dnn + head) * batch_size)
