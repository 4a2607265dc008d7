"""Starting a multi-process run: one process per device, each launched
alike (``torchrun --nproc-per-node N``, or by hand with the variables
below).

Counterpart of ``rec_now_tpu/parallel/multihost.py``.  JAX's
``initialize_multihost`` (:65-85) starts ``jax.distributed`` once, and
treats a host with no cluster as one process ("single-process
environment -- fine", :84).  :func:`initialize_multihost` does the same
with ``torch.distributed``:

* from ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (as
  ``torchrun`` sets them) when all four are set, or from an explicit
  ``init_method`` with ``rank`` and ``world_size`` (JAX's
  ``coordinator_address``, ``process_id`` and ``num_processes``; a
  ``file://`` path forms a group with no port);
* otherwise a group of one at rank 0, in memory.

The backend is NCCL for a CUDA device and gloo on the CPU.  A CUDA
process runs on ``cuda:LOCAL_RANK`` (0 without the variable).  The
group's ``timeout`` is finite, so a lost peer raises instead of hanging.

``put_local_batch`` (:88-107) has no counterpart: it builds a global
array from each process's rows, and the port has none.  Each process
places its own rows with ``Trainer.put_local``.

Example (two processes on one host, each with its file part)::

    torchrun --nproc-per-node 2 -m rec_now_tpu_torch.train --multihost \\
        --batch-size 16384 ...

or in code::

    device = initialize_multihost()           # once, before the mesh
    mesh = make_mesh(device)
    trainer = Trainer(model, fc, cfg, device=device, mesh=mesh)
    state = trainer.init(torch.Generator().manual_seed(0))
    state, metrics = trainer.train_step(state, *trainer.put_local(batch))
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from rec_now_tpu_torch.core.config import resolve_device

# what torchrun sets and env:// reads
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# how long a collective waits for a lost peer before it raises
TIMEOUT = datetime.timedelta(minutes=5)


def local_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This process's device: ``cuda`` is ``cuda:LOCAL_RANK``; a device
    with an index, or the CPU, as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(dev)


def initialize_multihost(device: Union[str, torch.device] = "cuda",
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout: datetime.timedelta = TIMEOUT
                         ) -> torch.device:
    """Join (or, alone, form) the default process group, once; returns
    this process's device.  A second call returns the device and leaves
    the group as it is."""
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None and all(k in os.environ for k in LAUNCH_VARS):
        init_method = "env://"
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=init_method,
            rank=-1 if rank is None else rank,
            world_size=-1 if world_size is None else world_size,
            timeout=timeout)
    return dev


def process_count() -> int:
    """The default process group's size, 1 without one (JAX's
    ``jax.process_count()``)."""
    return dist.get_world_size() if dist.is_initialized() else 1

