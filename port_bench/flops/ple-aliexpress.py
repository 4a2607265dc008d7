"""Model operations of ``ple-aliexpress`` a request, for the whole
request's share of the peak (``mfu.serve``).

An example: 2 operations a multiply-add of every product: the dense
floats' projection, every expert of both levels (4 shared and 4 a task,
2 tasks: 12 a level), the gates (a task's over 8 experts at each level,
the shared one's over 12 at every level but the last), each tower's
layers and its one-logit head.  At the published widths 0.016 +
26.739 + 3.146 + 0.138 + 0.164 = 30.20 MFLOP, 98.9% in the expert banks.
The gates' softmax, the combines' multiply-adds of experts by weights and
the biases are left out (under 0.2%).
"""


def example_flops(cfg: dict) -> int:
    d = cfg["embedding_dim"]
    width = (cfg["num_sparse_features"] + 1) * d
    shared, own = cfg["shared_expert_num"], cfg["specific_expert_num"]
    tasks = cfg["task_num"]
    experts = shared + tasks * own
    levels = cfg["bottom_mlp_dims"]
    macs = cfg["num_dense_features"] * d
    for j, dim in enumerate(levels):
        macs += experts * width * dim
        macs += tasks * width * (own + shared)
        if j < len(levels) - 1:
            macs += width * experts
        width = dim
    towers = [levels[-1]] + list(cfg["tower_mlp_dims"]) + [1]
    macs += tasks * sum(a * b for a, b in zip(towers, towers[1:]))
    return 2 * macs


def request_flops(cfg: dict, batch_size: int) -> float:
    return float(example_flops(cfg) * batch_size)
