"""Bound of B2, one CIN layer (``ops/cin_kernel.py``, ``_flat_fwd_cuda(x0,
prev, weight)``, what ``cin_flat`` and ``cin_contract`` launch): the
least operations of ``work.cin_flops`` (layer 1, whose prev is x0, on
its symmetric pairs); x0, prev and the weight read, the (M, K) output
written (PERF.md section 6, row 3)."""
import work as w

TARGET = "rec_now_tpu_torch.ops.cin_kernel:_flat_fwd_cuda"


def record(args, kwargs):
    x0, prev, weight = args[0], args[1], args[2]
    return {"m": x0.shape[0], "f": x0.shape[1], "h": prev.shape[1],
            "k": weight.shape[0],
            "prev_is_x0": prev.data_ptr() == x0.data_ptr()
            and prev.shape == x0.shape}


def work(rec):
    m, f, h, k = rec["m"], rec["f"], rec["h"], rec["k"]
    nbytes = (m * f + (0 if rec["prev_is_x0"] else m * h) + k * f * h
              + m * k) * 4
    return w.cin_flops(m, f, h, k, rec["prev_is_x0"]), nbytes
