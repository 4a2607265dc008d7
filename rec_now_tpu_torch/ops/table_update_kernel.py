"""Dense-apply optimizer passes over the embedding table
(``csrc/table_update.cu``), their wrappers and plain versions.

Counterparts of ``rec_now_tpu/ops/pallas/table_update_kernel.py`` on the
logical (V, D) table, without the TPU's lane packing, at any width D >= 1
as the TPU kernels take (on the card, D in {4, 8, 16, 32, 64, 128} runs
D / 4 threads a row; any other width, such as config 5's CAN table at
D = 272, a warp a row, on float4s where D % 4 == 0 and the tensors sit on
the 16-byte grid, else on floats):

* :func:`adagrad_dense_pass` (kernel B9) -- row-wise Adagrad, with a
  (V,) accumulator::

      acc   += mean_d g ** 2
      table -= lr / sqrt(max(acc, eps)) * g

* :func:`adam_dense_pass` (kernel B10) -- lazy Adam, with (V, D) moments
  ``m`` and ``v``, a (V,) bool ``touched`` flag (the rows the batch
  looked up) and the step ``count`` (a device int32, already advanced);
  only touched rows change::

      m      = b1 m + (1 - b1) g
      v      = b2 v + (1 - b2) g ** 2
      table -= lr (m / (1 - b1 ** t)) / (sqrt(v / (1 - b2 ** t)) + eps)

All versions update their tensors in place (the port keeps one copy of
the table; JAX returns new arrays and donates the old ones).  A wrapper
takes the plain version for CPU tensors and the kernel for CUDA tensors;
``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


def adagrad_dense_pass_plain(table: torch.Tensor, acc: torch.Tensor,
                             dense_g: torch.Tensor, lr: float,
                             eps: float = 1e-12) -> None:
    """In place: ``sharded.py:708-715`` on a (V, D) table."""
    acc.add_(dense_g.square().mean(dim=1))
    table.sub_((lr / acc.clamp_min(eps).sqrt())[:, None] * dense_g)


def adam_dense_pass_plain(table: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, dense_g: torch.Tensor,
                          touched: torch.Tensor, count: torch.Tensor,
                          lr: float, b1: float, b2: float,
                          eps: float) -> None:
    """In place: ``sharded.py:765-782`` on a (V, D) table; rows whose
    ``touched`` flag is clear keep table, m and v bit-identical."""
    tch = touched.bool()[:, None]
    m_new = torch.where(tch, b1 * m + (1 - b1) * dense_g, m)
    v_new = torch.where(tch, b2 * v + (1 - b2) * dense_g.square(), v)
    t = count.to(torch.float32)
    mhat = m_new / (1 - b1 ** t)
    vhat = v_new / (1 - b2 ** t)
    table.sub_(torch.where(tch, lr * mhat / (vhat.sqrt() + eps), 0.0))
    m.copy_(m_new)
    v.copy_(v_new)


def _lib() -> ctypes.CDLL:
    lib = _build.load("table_update")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adagrad_dense_f32.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                          i32, f32, f32, i32, ptr]
        lib.adagrad_dense_f32.restype = i32
        lib.adam_dense_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                       ctypes.c_longlong, i32, f32, f32, f32,
                                       f32, f32, f32, i32, ptr]
        lib.adam_dense_f32.restype = i32
        lib._typed = True
    return lib


def _check_rows(what: str, rows: int, d: int, **tensors) -> None:
    if d < 1:
        raise ValueError(f"{what}: embedding dim {d} < 1")
    for name, t in tensors.items():
        if t.shape[0] != rows or (t.dim() == 2 and t.shape[1] != d):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} does not "
                             f"match the table's ({rows}, {d})")


def adagrad_dense_pass(table: torch.Tensor, acc: torch.Tensor,
                       dense_g: torch.Tensor, lr: float,
                       eps: float = 1e-12) -> None:
    """Row-wise Adagrad over the whole table, in place: table (V, D),
    acc (V,), dense_g (V, D), all float32, any D >= 1; the mean of the
    squares divides by D."""
    if is_cpu(table, "adagrad_dense_pass"):
        adagrad_dense_pass_plain(table, acc, dense_g, lr, eps)
        return
    dev = table.device
    check_input("table", table, 2, dev)
    check_input("acc", acc, 1, dev)
    check_input("dense_g", dense_g, 2, dev)
    rows, d = table.shape
    _check_rows("adagrad_dense_pass", rows, d, acc=acc, dense_g=dense_g)
    lib = _lib()
    rc = lib.adagrad_dense_f32(table.data_ptr(), acc.data_ptr(),
                               dense_g.data_ptr(), rows, d, lr, eps,
                               dev.index, _build.stream_of(table))
    check_rc(lib, rc, "adagrad_dense_pass")
    adagrad_dense_pass.launches += 1


adagrad_dense_pass.launches = 0


def adam_dense_pass(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    dense_g: torch.Tensor, touched: torch.Tensor,
                    count: torch.Tensor, lr: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-7) -> None:
    """Lazy Adam over the whole table, in place: table, m, v, dense_g
    (V, D) float32, any D >= 1, touched (V,) bool, count a 0-d int32 step
    count (read on the device)."""
    if is_cpu(table, "adam_dense_pass"):
        adam_dense_pass_plain(table, m, v, dense_g, touched, count, lr, b1,
                              b2, eps)
        return
    dev = table.device
    for name, t in (("table", table), ("m", m), ("v", v),
                    ("dense_g", dense_g)):
        check_input(name, t, 2, dev)
    check_input("touched", touched, 1, dev, torch.bool)
    check_input("count", count, 0, dev, torch.int32)
    rows, d = table.shape
    _check_rows("adam_dense_pass", rows, d, m=m, v=v, dense_g=dense_g,
                touched=touched)
    lib = _lib()
    rc = lib.adam_dense_f32(table.data_ptr(), m.data_ptr(), v.data_ptr(),
                            dense_g.data_ptr(), touched.data_ptr(),
                            count.data_ptr(), rows, d, lr, b1, 1.0 - b1, b2,
                            1.0 - b2, eps, dev.index, _build.stream_of(table))
    check_rc(lib, rc, "adam_dense_pass")
    adam_dense_pass.launches += 1


adam_dense_pass.launches = 0
