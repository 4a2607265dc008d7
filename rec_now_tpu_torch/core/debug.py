"""Debug-print utilities.

Counterpart of ``rec_now_tpu/core/debug.py`` (the reference's
``tfprint`` / ``tfprintlist`` / ``tfprint_minmax``, gated on a
``do_print`` flag).  Each call prints in the JAX format (``desc
shape=(...) values=[...]`` / ``min=... max=...``) and returns its input
unchanged, so it can be threaded through a model; with
``do_print=False`` it is an identity.  Unlike ``jax.debug.print``, the
print reads the values on the host: on the card it waits for them.
"""
from __future__ import annotations

import torch


def _host(t: torch.Tensor):
    return t.detach().cpu().numpy()


def dbg_print(tensor: torch.Tensor, desc: str = "", do_print: bool = True,
              summarize: int = 32) -> torch.Tensor:
    """Print a tensor's shape and its first ``summarize`` values (of the
    flattened tensor); returns ``tensor`` unchanged."""
    if not do_print:
        return tensor
    flat = tensor.reshape(-1)[:summarize]
    print(desc + f" shape={tuple(tensor.shape)} values={_host(flat)}")
    return tensor


def dbg_minmax(tensor: torch.Tensor, desc: str = "",
               do_print: bool = True) -> torch.Tensor:
    """Print a tensor's shape, min and max; returns ``tensor``."""
    if not do_print:
        return tensor
    print(desc + f" shape={tuple(tensor.shape)} "
          f"min={_host(tensor.min())} max={_host(tensor.max())}")
    return tensor


def dbg_print_list(tensors, desc: str = "", do_print: bool = True,
                   summarize: int = 32):
    """Print each tensor of a list as ``desc[i]``; returns the list."""
    if not do_print:
        return tensors
    for i, t in enumerate(tensors):
        dbg_print(t, f"{desc}[{i}]", do_print=True, summarize=summarize)
    return tensors
