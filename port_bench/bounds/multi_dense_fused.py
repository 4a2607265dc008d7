"""Bound of B8's expert banks, ``multi_dense_fused(inputs, kernel, bias,
relu)`` (``ops/multi_dense_kernel.py``): (1|N, B, D) x (N, D, U), 2
operations a multiply-add, N * B * D * U of them; x, W and the bias read
once, the (N, B, U) output written.  A call's record keeps its shapes
only, no tensor."""
TARGET = "rec_now_tpu_torch.ops.multi_dense_kernel:multi_dense_fused"


def record(args, kwargs):
    inputs, kernel = args[0], args[1]
    bias = args[2] if len(args) > 2 else kwargs.get("bias")
    n, d, u = kernel.shape
    return {"nx": inputs.shape[0], "b": inputs.shape[1], "n": n, "d": d,
            "u": u, "bias": bias is not None}


def work(rec):
    nx, b, n, d, u = rec["nx"], rec["b"], rec["n"], rec["d"], rec["u"]
    nbytes = (nx * b * d + n * d * u + (n * u if rec["bias"] else 0)
              + n * b * u) * 4
    return 2 * n * b * d * u, nbytes
