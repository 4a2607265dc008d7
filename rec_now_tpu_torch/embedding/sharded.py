"""The trainer's embedding table, on one device or mod-sharded over a
process mesh, with row-wise Adagrad or lazy sparse Adam.

Counterpart of ``rec_now_tpu/embedding/sharded.py``
``ShardedEmbeddingTable`` (``sharded.py:105-834``) on its ``allgather``
exchange, with exact dedup (duplicate ids sum before the update).  The
state is a (V, D) table, a (V,) Adagrad accumulator and, under Adam,
(V, D) moments ``m``, ``v`` and a device step ``count``; the TPU's lane
packing is not kept (``convert`` reads a packed JAX state).

With no ``mesh`` the table is one shard and owns every row (JAX's
``n == 1`` path, :393-399, :493-495).  With a mesh of P processes
(``parallel/mesh.py``) the rows are mod-sharded as in JAX: global id
``i`` lives on process ``i % P`` at local row ``i // P``, the vocabulary
padded to a multiple of P (:141-143), so each process holds V / P rows
(``local_rows``) of the table, the accumulator and the moments.  Every
process draws the whole logical table from the generator and keeps its
own rows, so P processes start from the rows one process would.  Each
process passes its own ids; every process must pass as many.

* **lookup** (``_lookup_ag_body``, :491-506): ``all_gather`` the flat
  ids, gather the owned rows (kernel B11; a foreign id reads local row 0
  and is masked to zero), ``reduce_scatter`` (sum) each row back to the
  process that asked: exactly one owner adds a non-zero row, so a
  looked-up row is exact.  JAX pads the flat ids to a multiple of P
  (:470-477) because one global array must split evenly; here each
  process gathers and gets back its own count, so no padding is needed.
* **updates** (``_owned_grad_candidates``, :401-410): ``all_gather`` the
  ids and their row gradients, keep the owned ones (local row ``i //
  P``), give every foreign id the out-of-range sentinel ``local_rows``
  with a zero gradient, then run the one-shard update below on them.
  Every path drops the sentinel: B12 drops out-of-range rows, the dense
  Adam touched flag has a spare last slot for it, and the sparse
  Adagrad's plain accumulator add gives it exactly 0.

Two update paths, chosen by ``update_mode`` as in JAX (:598-608):

* **dense** -- scatter-add the batch's (N, D) row gradients into a zeroed
  f32 (V, D) buffer (kernel B12, ``scatter_add_rows``: duplicates sum),
  then one pass over the whole table in place: Adagrad (kernel B9) or,
  with a touched flag made from the ids, lazy Adam (kernel B10).  The
  buffer stays f32: the TPU's bf16 buffer (:672-673) is a TPU layout
  choice.
* **sparse** -- JAX's static-shape dedup (:553-573: stable sort,
  first-of-segment flags, ``cumsum``, a segment sum by B12, the sentinel
  row V for the unused segments), then the update of the distinct rows
  alone: their moments fetched by B11 (the sentinel clamps to row V - 1),
  and a delta written back by B12 as JAX does (:827-834), which drops the
  sentinel rows as JAX's scatter drops them (:234-236).  The (V,)
  Adagrad accumulator's scatter and gather stay plain, as JAX's
  ``_expand_scalar`` / ``_fetch_scalars`` are not Pallas.  Nothing waits
  for the card (no ``torch.unique``).

Kernel launches per step: lookup 1 x B11 (``table.lookup``); dense, 1 x
B12; sparse Adagrad, 2 x B12 (dedup, table); sparse Adam, 2 more x B11
(m, v) and 4 x B12 (dedup, table, m, v).

A row that was looked up is touched whatever its summed gradient: under
Adam its moments decay and it moves by ``lr * m_hat / (sqrt(v_hat) +
eps)`` even when that gradient is exactly zero (JAX counts every owned
occurrence, :753-757).  Untouched rows keep table, m and v bit-identical.

``update_mode="auto"`` picks dense while the local shard's bytes
(``local_rows`` * D * 4, as JAX judges the local shard, :150-160) stay
within the optimizer's
:data:`ShardedEmbeddingTable.DENSE_UPDATE_MAX_TABLE_BYTES`: the size at
which, on an NVIDIA H100, a dense pass costs what the sparse path costs
for one B = 8,192 batch of 26 fields (212,992 ids).  A dense pass grows
with V (the zero-filled buffer, and Adagrad's read and write of every
row; lazy Adam reads only a flag of an untouched row), the sparse path
with the batch's ids (its sort and scatters).  ``chip_smoke.py`` phase 3
times both and prints where they cross, which moves with the host (the
sparse path is ~30 host-bound launches); PERF.md §6 has the readings.
JAX's single 512 MiB limit on the streamed bytes was set for the TPU.  No configuration of the repo has a
table past these limits, so ``auto`` never reaches sparse there: the
sparse path is kept for parity with JAX's ``update_mode`` option.

Example:
    table = ShardedEmbeddingTable(vocab_size=2_600_000, dim=16,
                                  optimizer="adam")
    state = table.init(torch.Generator().manual_seed(0))
    emb = table.lookup(state, ids)                  # ids.shape + (D,)
    state = table.apply_grads(state, ids, emb_grads, lr=1e-3)

    # the same on each process of a mesh, each with its own ids
    table = ShardedEmbeddingTable(2_600_000, 16, mesh=make_mesh())
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from rec_now_tpu_torch.core.config import uniform
from rec_now_tpu_torch.embedding.table import INIT_SCALE, EmbeddingTable
from rec_now_tpu_torch.ops import table_update_kernel
from rec_now_tpu_torch.ops.expand_kernel import scatter_add_rows
from rec_now_tpu_torch.ops.gather_kernel import gather_rows

# Adagrad's initial accumulator (sharded.py:122, the JAX default)
INITIAL_ACCUMULATOR = 0.1


def shard_rows(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """A copy of the rows of (V, ...) ``x`` that process ``rank`` of
    ``size`` owns (``rank``, ``rank + size``, ...), V padded with zeros to
    a multiple of ``size``: (ceil(V / size), ...)."""
    pad = -x.shape[0] % size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x[rank::size].clone(memory_format=torch.contiguous_format)


class ShardedTableState(NamedTuple):
    """What an update changes: the rows, their Adagrad accumulators and,
    under Adam, the moments and the step count (on a mesh, this process's
    ``local_rows`` rows of each)."""
    table: torch.Tensor                    # (V, D) float32
    accumulator: torch.Tensor              # (V,) float32
    m: Optional[torch.Tensor] = None       # (V, D) Adam first moment
    v: Optional[torch.Tensor] = None       # (V, D) Adam second moment
    count: Optional[torch.Tensor] = None   # () int32 Adam step count


class ShardedEmbeddingTable:
    """(V, D) table on one device, or mod-sharded over ``mesh``: ``init``,
    ``lookup``, ``apply_grads``; the rows are the serving
    :class:`EmbeddingTable`'s.

    Args:
        vocab_size, dim: the table's shape; any dim >= 1 runs both
            update paths (config 5's CAN table is 100,000 x 272).
        device: where it lives ("cuda" unless asked otherwise; on a mesh,
            the mesh's device).
        initializer_scale: rows start in U(-scale, scale) (the JAX
            table's 1e-3 default; the CAN table takes 0.05).
        optimizer: ``"adagrad"`` (row-wise) or ``"adam"`` (lazy).
        update_mode: ``"auto"``, ``"dense"`` or ``"sparse"``.
        beta1, beta2, eps: Adam's (the JAX table's defaults; eps 1e-7,
            in the denominator as ``sqrt(v_hat) + eps``).
        mesh: a :class:`~rec_now_tpu_torch.parallel.Mesh` to shard the
            rows over (module docstring), or None for one device.
    """

    # dense-apply is chosen up to these table bytes (module docstring):
    # inside the crossings measured on the H100 since the sparse path's
    # gathers and write-backs run B11 / B12 and drop its sentinel rows
    # (before, index_add_ sent them to row V - 1): 532-911 MiB (Adagrad;
    # 713-876 before) and 1,340-3,908 MiB (Adam; 3.23-4.00 GiB before)
    # over nine runs, the sparse path's time moving with the host, so no
    # fixed limit is right on every host
    DENSE_UPDATE_MAX_TABLE_BYTES = {"adagrad": 640 * 2 ** 20,
                                    "adam": 1800 * 2 ** 20}

    def __init__(self, vocab_size: int, dim: int,
                 device: Union[str, torch.device] = "cuda",
                 initializer_scale: float = INIT_SCALE,
                 optimizer: str = "adagrad", update_mode: str = "auto",
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-7, mesh=None):
        if optimizer not in ("adagrad", "adam"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        if update_mode not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown update_mode {update_mode!r}")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.rows = EmbeddingTable(vocab_size, dim, device,
                                   initializer_scale)
        self.num_shards = 1 if mesh is None else mesh.size
        # padded to a multiple of the shards (sharded.py:141-143)
        self.vocab_size = vocab_size + -vocab_size % self.num_shards
        self.local_rows = self.vocab_size // self.num_shards
        self.dim = dim
        self.device = self.rows.device
        self.optimizer = optimizer
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        if update_mode == "auto":
            limit = self.DENSE_UPDATE_MAX_TABLE_BYTES[optimizer]
            update_mode = ("dense" if self.local_rows * dim * 4 <= limit
                           else "sparse")
        self.update_mode = update_mode

    def init(self, generator: torch.Generator) -> ShardedTableState:
        """Rows ~ U(-initializer_scale, initializer_scale) drawn on the
        CPU, accumulators at 0.1 and, under Adam, zero moments and count,
        all on the device (``sharded.py:283-315``).  On a mesh the whole
        logical table is drawn and this process keeps its rows."""
        if self.mesh is None:
            return self.state_from(self.rows.init(generator))
        rows = self.rows
        full = uniform((rows.vocab_size, self.dim), rows.initializer_scale,
                       generator)
        return self.state_from(shard_rows(full, self.mesh.rank,
                                          self.mesh.size).to(self.device))

    def state_from(self, table: torch.Tensor) -> ShardedTableState:
        """A fresh optimizer state around the (``local_rows``, D) rows
        ``table``."""
        acc = torch.full((self.local_rows,), INITIAL_ACCUMULATOR,
                         dtype=torch.float32, device=self.device)
        if self.optimizer != "adam":
            return ShardedTableState(table, acc)
        return ShardedTableState(
            table, acc, torch.zeros_like(table), torch.zeros_like(table),
            torch.zeros((), dtype=torch.int32, device=self.device))

    def lookup(self, state: ShardedTableState,
               ids: torch.Tensor) -> torch.Tensor:
        """Gather rows: int global ids of any shape -> ids.shape + (D,)."""
        mesh = self.mesh
        if mesh is None:
            return self.rows.lookup(state.table, ids)
        all_ids = mesh.all_gather(ids.reshape(-1))
        mine = all_ids % mesh.size == mesh.rank
        rows = gather_rows(state.table,
                           torch.where(mine, all_ids // mesh.size, 0))
        rows = rows * mine.to(rows.dtype)[:, None]
        return mesh.reduce_scatter(rows).reshape(ids.shape + (self.dim,))

    def _owned(self, ids: torch.Tensor, grads: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every process's flat ids and row gradients -> (local rows, with
        the sentinel ``local_rows`` for a foreign id, and the gradients,
        zero for a foreign id) (``sharded.py:401-410``)."""
        mesh = self.mesh
        all_ids, all_grads = mesh.all_gather(ids), mesh.all_gather(grads)
        mine = all_ids % mesh.size == mesh.rank
        rows = torch.where(mine, all_ids // mesh.size, self.local_rows)
        return rows, all_grads * mine.to(all_grads.dtype)[:, None]

    def apply_grads(self, state: ShardedTableState, ids: torch.Tensor,
                    grads: torch.Tensor, lr: float) -> ShardedTableState:
        """One optimizer step on the rows from gradients w.r.t. the
        looked-up rows (``ids.shape + (D,)``, global ids), duplicates
        summed first.  Updates ``state`` in place (Adam's count too) and
        returns it."""
        ids = ids.reshape(-1).to(torch.int64)
        grads = grads.reshape(-1, self.dim).to(torch.float32)
        if self.mesh is not None:
            ids, grads = self._owned(ids, grads)
        if self.optimizer == "adam":
            state.count.add_(1)              # before the update (:738)
        if self.update_mode == "dense":
            dense_g = scatter_add_rows(torch.zeros_like(state.table), ids,
                                       grads)
            if self.optimizer == "adam":
                # a spare last flag takes the sentinel of a foreign id
                touched = torch.zeros(self.local_rows + 1, dtype=torch.bool,
                                      device=ids.device)
                touched.index_fill_(0, ids, True)
                table_update_kernel.adam_dense_pass(
                    state.table, state.m, state.v, dense_g,
                    touched[:self.local_rows], state.count, lr, self.beta1,
                    self.beta2, self.eps)
            else:
                table_update_kernel.adagrad_dense_pass(
                    state.table, state.accumulator, dense_g, lr)
            return state
        rows, row_grad, valid = self._dedup_rows(ids, grads)
        if self.optimizer == "adam":
            self._adam_sparse(state, rows, row_grad, valid, lr)
        else:
            self._adagrad_sparse(state, rows, row_grad, valid, lr)
        return state

    def _dedup_rows(self, ids: torch.Tensor, grads: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Static-shape dedup (``sharded.py:553-573``): (rows (N,), the
        distinct ids first and then the out-of-range sentinel
        ``local_rows`` for each unused segment and for the foreign ids,
        row_grad (N, D) their summed gradients (zeros for the unused),
        valid (N, 1) float 1 for a distinct id, 0 otherwise)."""
        n = ids.shape[0]
        order = torch.argsort(ids, stable=True)
        sid = ids[order]
        first = torch.ones(n, dtype=torch.bool, device=ids.device)
        first[1:] = sid[1:] != sid[:-1]
        seg = torch.cumsum(first, 0) - 1
        row_grad = scatter_add_rows(torch.zeros_like(grads), seg,
                                    grads[order])
        rep = torch.full((n,), self.local_rows, dtype=sid.dtype,
                         device=ids.device).scatter_(0, seg, sid)
        valid = (rep < self.local_rows).to(grads.dtype)[:, None]
        return rep, row_grad, valid

    def _adam_sparse(self, state: ShardedTableState, rows: torch.Tensor,
                     row_grad: torch.Tensor, valid: torch.Tensor,
                     lr: float) -> None:
        """``sharded.py:809-834`` on the deduped rows (the sentinel reads
        the last row and its write-backs are dropped)."""
        b1, b2, eps = self.beta1, self.beta2, self.eps
        m_rows, v_rows = gather_rows(state.m, rows), gather_rows(state.v, rows)
        m_new = b1 * m_rows + (1 - b1) * row_grad
        v_new = b2 * v_rows + (1 - b2) * row_grad.square()
        t = state.count.to(torch.float32)
        mhat = m_new / (1 - b1 ** t)
        vhat = v_new / (1 - b2 ** t)
        update = lr * mhat / (vhat.sqrt() + eps)
        scatter_add_rows(state.table, rows, -update * valid)
        scatter_add_rows(state.m, rows, (m_new - m_rows) * valid)
        scatter_add_rows(state.v, rows, (v_new - v_rows) * valid)

    def _adagrad_sparse(self, state: ShardedTableState, rows: torch.Tensor,
                        row_grad: torch.Tensor, valid: torch.Tensor,
                        lr: float) -> None:
        """``sharded.py:624-650`` with exact dedup on the deduped rows; the
        accumulator's scatter and gather are plain: the sentinel lands on
        the last row with valid 0, so it adds exactly 0 there."""
        sq = row_grad.square().mean(dim=1) * valid[:, 0]
        in_range = rows.clamp_max(self.local_rows - 1)
        state.accumulator.index_add_(0, in_range, sq)
        acc_rows = state.accumulator[in_range]
        scale = lr / acc_rows.clamp_min(1e-12).sqrt()[:, None] * valid
        scatter_add_rows(state.table, rows, -scale * row_grad)
