"""The process mesh of multi-process training: one process per device,
joined by ``torch.distributed``.

Counterpart of ``rec_now_tpu/parallel/mesh.py`` (``DATA_AXIS``,
``make_mesh``, :29-37).  The JAX mesh is one axis ``"data"`` over every
chip: the batch is split over it, the dense parameters are replicated and
their gradients summed, and the embedding rows are mod-sharded over the
same axis.  The port keeps that layout with one process per device: a
:class:`Mesh` holds the process group, this process's ``rank``, the group's
``size`` and the process's ``device``, and runs the collectives the
sharded table and the trainer call.  Each goes through
``torch.distributed``'s function of that name, looked up at the call, so a
caller can count them.

``data_sharding`` and ``replicated_sharding`` (:40-49) have no
counterpart: the port builds no global arrays.  Each process holds its
own slice of the batch and its own rows of the table, and the dense
parameters are plain tensors that every process keeps equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis ``DATA_AXIS`` of ``size`` processes in ``group``; this one
    is ``rank`` on ``device``."""
    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x`` (equal shapes) stacked along dim 0 in rank
        order: (size * n, ...) (JAX's ``all_gather(tiled=True)``)."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over processes of (size * n, ...) ``x``, of which this
        process keeps block ``rank``: (n, ...) (JAX's ``psum_scatter(
        tiled=True)``)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(size * n, ...) ``x`` whose block s goes to process s -> the
        blocks every process sent this one, in rank order: (size * n, ...)
        (JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``; a copy on a
        group of one)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over processes, in place (JAX's ``psum``)."""
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather_object(self, obj) -> list:
        """Every process's picklable ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` overwritten in place with process ``src``'s."""
        dist.broadcast(x, src, group=self.group)
        return x


def make_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    """The mesh of every process of the default group, with this process
    on ``device``.  Without a process group yet, forms one
    (:func:`~rec_now_tpu_torch.parallel.multihost.initialize_multihost`:
    from the launcher's variables, or a group of one)."""
    from rec_now_tpu_torch.parallel.multihost import initialize_multihost
    dev = initialize_multihost(device)
    return Mesh(dist.get_rank(), dist.get_world_size(), dev,
                dist.group.WORLD)
