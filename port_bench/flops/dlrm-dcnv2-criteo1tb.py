"""Model operations of ``dlrm-dcnv2-criteo1tb`` a request, for the whole
request's share of the peak (``mfu.serve``).

An example: 2 operations a multiply-add of every product: the dense
arch's layers, each cross layer's V (x0 wide -> rank) and W (rank -> x0
wide), the over arch's layers and its one-logit unit.  At the published
widths 0.34 + 21.23 + 10.49 = 32.06 MFLOP.  The pooling's adds, the
cross's elementwise terms and the biases are left out (under 0.2%).
"""


def example_flops(cfg: dict) -> int:
    dense = [cfg["num_dense_features"]] + list(cfg["dense_arch_layer_sizes"])
    x0 = (cfg["num_sparse_features"] + 1) * cfg["embedding_dim"]
    over = [x0] + list(cfg["over_arch_layer_sizes"])
    macs = sum(a * b for a, b in zip(dense, dense[1:]))
    macs += cfg["dcn_num_layers"] * 2 * x0 * cfg["dcn_low_rank_dim"]
    macs += sum(a * b for a, b in zip(over, over[1:]))
    return 2 * macs


def request_flops(cfg: dict, batch_size: int) -> float:
    return float(example_flops(cfg) * batch_size)
