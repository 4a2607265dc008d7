"""Static-shape dedup and owner-bucketed routing for the sharded table's
routed exchange.

Counterpart of ``rec_now_tpu/embedding/exchange.py``, which the port copies
function for function: ``BIG``, :class:`RoutePlan`, :func:`sort_dedup`,
:func:`plan_route`, :func:`gather_planned` and :func:`scatter_planned`.
The allgather exchange sends every process's ids and rows to every process
(O(P * b * D) a process); the routed exchange sends each owner only the
distinct ids it owns:

    sort-dedup the local ids  ->  bucket them by owner (static capacity)
    ->  all_to_all the ids    ->  the owner gathers its rows
    ->  all_to_all the rows back  ->  un-dedup to the original order

Every shape is fixed by b, P and the caps, as in JAX: the dedup is a sort
with ``BIG`` sentinels past the distinct ids, each owner's bucket holds
``cap`` ids, and the ids past a full bucket spill to an ``ov_cap`` lane
that travels by all_gather.  Ids past both (an owner's share beyond
``cap`` and a spill beyond ``ov_cap``) are dropped and counted in
``RoutePlan.dropped``; a dropped id reads zero and takes no update.

The plan is plain PyTorch on the caller's device (JAX's is XLA outside
any Pallas kernel) and equals JAX's plan value for value: the owner sort
is stable, the bucket position is a running maximum of the bucket starts,
and JAX's out-of-range ``.at[].set(mode="drop")`` scatters write one
spare slot here, sliced off after.  The port's ids are int64; ``BIG``
stays 2**30, and a sentinel never picks an owner.

Symbols: b flat ids of this process, P (``n``) processes, cap an owner's
bucket, ov_cap the overflow lane, D the row width.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# the sentinel id: sorts after every real id, owns no row
BIG = 2 ** 30


class RoutePlan(NamedTuple):
    """The owner-bucketed route of one process's distinct ids.

    ``send_ids`` and ``ov_ids`` travel; ``ret_slot`` and ``ov_slot`` give,
    for each distinct slot, the position of its row in the returned
    buffers (-1: not there)."""
    send_ids: torch.Tensor   # (n * cap,) block s: the ids process s owns
    ret_slot: torch.Tensor   # (b,) position in the send buffer, or -1
    ov_ids: torch.Tensor     # (ov_cap,) the spilled ids, BIG-padded
    ov_slot: torch.Tensor    # (b,) position in the overflow lane, or -1
    dropped: torch.Tensor    # () ids lost to both overflows


def sort_dedup(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape unique: (b,) ids -> ((b,) uid, (b,) slot).

    ``uid[k]`` is the k-th distinct id (ascending), ``BIG`` past the
    distinct count; ``slot[i]`` is item i's distinct slot, so
    ``rows_unique[slot]`` un-dedups a per-slot result."""
    b = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sid = flat[order]
    first = torch.ones(b, dtype=torch.bool, device=flat.device)
    first[1:] = sid[1:] != sid[:-1]
    upos = torch.cumsum(first, 0) - 1
    uid = torch.full((b,), BIG, dtype=flat.dtype, device=flat.device)
    uid[upos] = sid                     # equal ids write one value
    slot = torch.empty(b, dtype=torch.int64, device=flat.device)
    slot[order] = upos
    return uid, slot


def _set_dropping(size: int, fill: int, index: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """A (size,) + values.shape[1:] tensor of ``fill`` with ``values`` set
    at ``index``; an index of ``size`` lands in a spare slot that is cut
    off (JAX's ``.at[index].set(values, mode="drop")``)."""
    out = values.new_full((size + 1,) + tuple(values.shape[1:]), fill)
    out.index_copy_(0, index.to(torch.int64), values)
    return out[:size]


def plan_route(uid: torch.Tensor, n: int, cap: int,
               ov_cap: int) -> RoutePlan:
    """Bucket distinct ids by owner (``id % n``), ``cap`` a bucket.

    Args:
        uid: (b,) distinct ids with ``BIG`` sentinels (:func:`sort_dedup`).
        n: the process count.
        cap: an owner's bucket in the all_to_all buffer.
        ov_cap: the overflow (all_gather) lane's length.
    """
    b = uid.shape[0]
    dev = uid.device
    valid = uid < BIG
    owner = torch.where(valid, uid % n, n)     # sentinels own nothing
    oorder = torch.argsort(owner, stable=True)  # sentinels sort last
    o_s, uid_s = owner[oorder], uid[oorder]
    pos = torch.arange(b, device=dev)
    is_start = torch.ones(b, dtype=torch.bool, device=dev)
    is_start[1:] = o_s[1:] != o_s[:-1]
    group_start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    pib = pos - group_start                    # position in the bucket
    real = o_s < n
    in_main = real & (pib < cap)
    row = torch.where(in_main, o_s * cap + pib, n * cap)
    send_ids = _set_dropping(n * cap, BIG, row, uid_s)

    is_ov = real & (pib >= cap)
    ov_rank = torch.cumsum(is_ov, 0) - 1
    in_ov = is_ov & (ov_rank < ov_cap)
    ov_ids = _set_dropping(ov_cap, BIG, torch.where(in_ov, ov_rank, ov_cap),
                           uid_s)

    # each distinct slot (in id order) -> its buffer position
    ret_slot = torch.empty(b, dtype=torch.int64, device=dev)
    ret_slot[oorder] = torch.where(in_main, row, -1)
    ov_slot = torch.empty(b, dtype=torch.int64, device=dev)
    ov_slot[oorder] = torch.where(in_ov, ov_rank, -1)
    dropped = (is_ov & ~in_ov).sum()
    return RoutePlan(send_ids, ret_slot, ov_ids, ov_slot, dropped)


def gather_planned(plan: RoutePlan, recv_rows: torch.Tensor,
                   ov_rows: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Per-item rows from the returned buffers.

    Args:
        plan: the route the ids went by.
        recv_rows: (n * cap, D) rows back from the second all_to_all
            (position k: the row of ``send_ids[k]``).
        ov_rows: (ov_cap, D) the overflow ids' rows.
        slot: (b,) item -> distinct slot (:func:`sort_dedup`).

    Returns:
        (b, D) rows in the items' order; a dropped id reads zero.
    """
    main = torch.where(plan.ret_slot[:, None] >= 0,
                       recv_rows[plan.ret_slot.clamp_min(0)], 0.0)
    ov = torch.where(plan.ov_slot[:, None] >= 0,
                     ov_rows[plan.ov_slot.clamp_min(0)], 0.0)
    return (main + ov)[slot]                   # disjoint by construction


def scatter_planned(plan: RoutePlan, vals_unique: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot values (b, D) (e.g. summed gradients) -> ((n * cap, D) send
    buffer, (ov_cap, D) overflow buffer), zero where no id sits."""
    n_cap, ov_cap = plan.send_ids.shape[0], plan.ov_ids.shape[0]
    send = _set_dropping(
        n_cap, 0, torch.where(plan.ret_slot >= 0, plan.ret_slot, n_cap),
        vals_unique)
    ov = _set_dropping(
        ov_cap, 0, torch.where(plan.ov_slot >= 0, plan.ov_slot, ov_cap),
        vals_unique)
    return send, ov
