"""In-batch pairwise BPR loss and its counting kernels
(``csrc/pairwise.cu``), their wrappers and plain versions.

Counterparts of ``rec_now_tpu/ops/pallas/pairwise_kernel.py`` with every
option of its kernel path.  A pair (i, j) is valid when each group
condition holds (``groups`` is one (B,) tensor, a list of them or an
(NG, B) tensor: the conditions AND-combine, the first is the main
group), i != j, ``label_i > label_j`` (any float labels), the sample
mask is > 0.5 on both sides (a 0/1 mask; None = all valid) and, with
``wrong_order``, ``x_i < x_j``.

* :func:`pair_row_counts` (B7a) -- (B,) valid pairs anchored at each row.
* :func:`same_group_matvec` (B7b) -- ``out[i] = sum_k [g_i == g_k]
  vec[k]`` over one group vector.
* :func:`group_pair_counts_binary` (B7c) -- ``pos(g_i) * (tot(g_i) -
  pos(g_i))`` over one group, with pos the sum of mask * label and tot
  the sum of mask, as the TPU kernel sums them: the pair count of row
  i's group for binary labels and a 0/1 mask (the same identity, over
  members with label > 0.5 and mask > 0.5, is inside the loss kernel).
* :func:`pair_loss_fused` (B3) -- ``(loss_sum, n_pair, dlogits)`` of
  ``sum_valid w_i softplus(-(x_i - x_j) factor)``, with optional row
  weights ``w`` and, when ``occurrence_power != 0``, the occurrence weight
  ``(pos(g) * neg(g)) ** power`` computed in the kernel (binary labels,
  one group, no wrong-order filter; otherwise it raises, as JAX's does).
* :func:`pair_loss_general` -- B3's ``(loss_sum, n_pair, dlogits)`` with
  each row weighted by ``gpc ** power`` (0 where gpc is 0), gpc the
  valid pairs of the rows of its main group: JAX's general
  occurrence-weighted loss (``pairwise_kernel.py:451-461``, B7a -> B7b ->
  the weights -> B3) as one call.
* :func:`pair_loss_sum` and :func:`pair_loss_general_sum` --
  ``(loss_sum, n_pair)`` through one ``torch.autograd.Function``: the
  forward stashes dlogits, the backward only scales it; ``n_pair`` and the
  weights are not differentiable.

Each wrapper takes its ``*_plain`` version (the (B, B) formulas) for CPU
tensors and its kernel for CUDA tensors; ``<wrapper>.launches`` counts
kernel launches (``pair_loss_sum.launches`` counts ``pair_loss_fused``'s
and ``pair_loss_general``'s).  At B <= :data:`SORT_MAX` B3, B7a and the
general loss sort the batch by its main group and work inside each group
(the general loss on one sort: B7a's count sweep sums each group's pairs
for B3's sweep, four launches) and B7c sorts and sums each group in one
block; past it, O(B^2) sweeps run.  B7b sums each group through a hash
of its ids at any B (the general loss's past :data:`SORT_MAX` too).
``_pair_row_counts``, ``_group_pair_counts_binary`` and
``_pair_loss_general`` force a path.  The counts are f32, as JAX's, from
integer sums on the card (B7b's and B7c's sums in double).  The kernel's
column tile is a compile-time constant (no tile override exists).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu
from rec_now_tpu_torch.ops.listwise_kernel import PATHS, SORT_MAX

GroupLike = Union[torch.Tensor, Sequence[torch.Tensor]]

# scratch kinds of csrc/pairwise.cu's pair_scratch_words
_LOSS, _ROW_COUNTS, _MATVEC, _BINARY, _GENERAL = 0, 1, 2, 3, 4


def group_rows(groups: GroupLike) -> torch.Tensor:
    """One (B,) group tensor, a list of them or an (NG, B) tensor ->
    (NG, B)."""
    if isinstance(groups, torch.Tensor):
        return groups.reshape(1, -1) if groups.dim() <= 1 else groups
    return torch.stack([g.reshape(-1) for g in groups])


def _pair_mask(logits: torch.Tensor, labels: torch.Tensor, groups: GroupLike,
               sample_mask: Optional[torch.Tensor],
               wrong_order: bool) -> torch.Tensor:
    """(B, B) bool validity of every pair (i, j), i the positive side
    (``pairwise_kernel.py:105-128``)."""
    g = group_rows(groups)
    same = (g[:, :, None] == g[:, None, :]).all(dim=0)
    lab = labels.float()
    eye = torch.eye(lab.shape[0], dtype=torch.bool, device=lab.device)
    valid = same & ~eye & (lab[:, None] > lab[None, :])
    if sample_mask is not None:
        m = sample_mask > 0.5
        valid &= m[:, None] & m[None, :]
    if wrong_order:
        x = logits.float()
        valid &= x[:, None] < x[None, :]
    return valid


def pair_row_counts_plain(logits: torch.Tensor, labels: torch.Tensor,
                          groups: GroupLike,
                          sample_mask: Optional[torch.Tensor] = None,
                          wrong_order: bool = False) -> torch.Tensor:
    """(B,) valid pairs anchored at each row, f32."""
    return _pair_mask(logits, labels, groups, sample_mask,
                      wrong_order).float().sum(dim=1)


def same_group_matvec_plain(groups: torch.Tensor,
                            vec: torch.Tensor) -> torch.Tensor:
    """(B,) ``sum_k [g_i == g_k] vec[k]``, summed in float64 and rounded
    once to f32, as the kernel does."""
    g = groups.reshape(-1)
    return ((g[:, None] == g[None, :]).double() @ vec.double()).float()


def group_pair_counts_binary_plain(groups: torch.Tensor,
                                   labels: torch.Tensor,
                                   sample_mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """(B,) ``pos * (tot - pos)`` over row i's group with pos = sum of
    mask * label and tot = sum of mask (``pairwise_kernel.py:220-225``),
    summed and multiplied in float64 and rounded once to f32, as the
    kernel does: f32 sums lose the difference where tot - pos is small
    beside pos (graded labels, a fractional mask, a large group)."""
    lab = labels.float()
    m = torch.ones_like(lab) if sample_mask is None else sample_mask.float()
    g = groups.reshape(-1)
    same = (g[:, None] == g[None, :]).double()
    pos = same @ (m * lab).double()
    return (pos * (same @ m.double() - pos)).float()


def pair_loss_fused_plain(logits: torch.Tensor, labels: torch.Tensor,
                          groups: GroupLike, factor: float = 1.0,
                          occurrence_power: float = 0.0, *,
                          row_weights: Optional[torch.Tensor] = None,
                          sample_mask: Optional[torch.Tensor] = None,
                          wrong_order: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(loss_sum, n_pair, dlogits) from (B, B) tensors, written out
    (``pairwise_kernel.py:302-346``)."""
    g = group_rows(groups)
    _check_occurrence(g, occurrence_power, wrong_order)
    x = logits.float()
    valid = _pair_mask(x, labels, g, sample_mask, wrong_order).float()
    w = (torch.ones_like(x) if row_weights is None
         else row_weights.float())
    if occurrence_power != 0.0:
        gpc = group_pair_counts_binary_plain(g[0], labels, sample_mask)
        w = w * torch.where(gpc > 0,
                            gpc.clamp_min(1e-30) ** occurrence_power,
                            torch.zeros_like(gpc))
    d = (x[:, None] - x[None, :]) * factor
    wm = valid * w[:, None]
    softplus = torch.clamp_min(-d, 0.0) + torch.log1p(torch.exp(-d.abs()))
    loss = (softplus * wm).sum()
    s = -torch.sigmoid(-d) * factor * wm
    return loss, valid.sum(), s.sum(1) - s.sum(0)


def pair_loss_general_plain(logits: torch.Tensor, labels: torch.Tensor,
                            groups: GroupLike, factor: float = 1.0,
                            occurrence_power: float = -0.5, *,
                            sample_mask: Optional[torch.Tensor] = None,
                            wrong_order: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(loss_sum, n_pair, dlogits) of the general loss as JAX composes it
    (``pairwise_kernel.py:451-461``): B7a's row counts, B7b's sums over
    the main group (gpc), the row weights ``gpc ** power`` (0 where gpc
    is 0), then B3 with those weights; each step's plain version."""
    g = group_rows(groups)
    counts = pair_row_counts_plain(logits, labels, g, sample_mask,
                                   wrong_order)
    gpc = same_group_matvec_plain(g[0], counts)
    w = torch.where(gpc > 0, gpc.clamp_min(1e-30) ** occurrence_power,
                    torch.zeros_like(gpc))
    return pair_loss_fused_plain(logits, labels, g, factor, row_weights=w,
                                 sample_mask=sample_mask,
                                 wrong_order=wrong_order)


def _check_occurrence(g: torch.Tensor, power: float,
                      wrong_order: bool) -> None:
    if power != 0.0 and (g.shape[0] != 1 or wrong_order):
        raise ValueError("in-kernel occurrence weighting needs a single "
                         "group condition and no wrong-order filter")


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pair_max_groups.restype = i32
        lib.pair_scratch_words.argtypes = [i32, i32, i32]
        lib.pair_scratch_words.restype = ctypes.c_longlong
        lib.pair_loss_f32.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, f32,
                                      f32, i32, ptr, ptr, ptr, i32, ptr]
        lib.row_counts_f32.argtypes = [ptr, ptr, ptr, i32, ptr, i32, i32,
                                       i32, ptr, ptr, i32, ptr]
        lib.group_matvec_f32.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr]
        lib.binary_counts_f32.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr,
                                          i32, ptr]
        lib.pair_loss_general_f32.argtypes = [ptr, ptr, ptr, i32, ptr, i32,
                                              f32, f32, i32, i32, ptr, ptr,
                                              ptr, i32, ptr]
        for fn in (lib.pair_loss_f32, lib.row_counts_f32,
                   lib.group_matvec_f32, lib.binary_counts_f32,
                   lib.pair_loss_general_f32):
            fn.restype = i32
        lib._typed = True
    return lib


def _vectors(b: int, dev: torch.device, **vecs) -> None:
    """Check each given (B,) f32 vector (None is allowed)."""
    for name, t in vecs.items():
        if t is None:
            continue
        check_input(name, t, 1, dev)
        if t.shape[0] != b:
            raise ValueError(f"{name} {tuple(t.shape)} must have length {b}")


def _groups(groups: GroupLike, b: int, dev: torch.device,
            lib: ctypes.CDLL) -> torch.Tensor:
    g = group_rows(groups).to(torch.int32).contiguous()
    check_input("groups", g, 2, dev, torch.int32)
    if g.shape[1] != b or not 1 <= g.shape[0] <= lib.pair_max_groups():
        raise ValueError(f"groups {tuple(g.shape)}: expected 1 to "
                         f"{lib.pair_max_groups()} conditions of length {b}")
    return g


def _scratch(lib: ctypes.CDLL, kind: int, b: int, dev: torch.device,
             path: int = 0) -> Optional[torch.Tensor]:
    """The scratch of entry point ``kind`` on the path numbered ``path``
    (None where it takes none)."""
    words = lib.pair_scratch_words(kind, b, path)
    if words < 0:
        raise ValueError(f"no path {path} for a batch of {b}")
    return (torch.empty(words, dtype=torch.float32, device=dev) if words
            else None)


def _check_path(b: int, path: str) -> None:
    if path == "sort" and b > SORT_MAX:
        raise ValueError(f"the sort path takes B <= {SORT_MAX}, got {b}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def pair_row_counts(logits: torch.Tensor, labels: torch.Tensor,
                    groups: GroupLike,
                    sample_mask: Optional[torch.Tensor] = None,
                    wrong_order: bool = False) -> torch.Tensor:
    """(B,) f32 valid pairs anchored at each row; logits, labels and the
    mask (B,) float32, groups as in the module docstring.  Not
    differentiable."""
    return _pair_row_counts(logits, labels, groups, sample_mask,
                            wrong_order, "auto")


def _pair_row_counts(logits: torch.Tensor, labels: torch.Tensor,
                     groups: GroupLike, sample_mask: Optional[torch.Tensor],
                     wrong_order: bool, path: str) -> torch.Tensor:
    """:func:`pair_row_counts` on the kernel's ``path`` (a key of
    :data:`PATHS`; a CPU tensor takes the plain version whatever it is)."""
    if is_cpu(logits, "pair_row_counts"):
        return pair_row_counts_plain(logits, labels, groups, sample_mask,
                                     wrong_order)
    dev, b = logits.device, logits.shape[0]
    _vectors(b, dev, logits=logits, labels=labels, sample_mask=sample_mask)
    lib = _lib()
    g = _groups(groups, b, dev, lib)
    _check_path(b, path)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scratch = _scratch(lib, _ROW_COUNTS, b, dev, PATHS[path])
    rc = lib.row_counts_f32(logits.data_ptr(), labels.data_ptr(),
                            g.data_ptr(), g.shape[0], _ptr(sample_mask), b,
                            int(wrong_order), PATHS[path], _ptr(scratch),
                            out.data_ptr(), dev.index,
                            _build.stream_of(logits))
    check_rc(lib, rc, "pair_row_counts")
    pair_row_counts.launches += 1
    return out


pair_row_counts.launches = 0


def same_group_matvec(groups: torch.Tensor,
                      vec: torch.Tensor) -> torch.Tensor:
    """(B,) f32 ``sum_k [g_i == g_k] vec[k]``: groups (B,) int, vec (B,)
    float32.  Summed in double on the card through a hash of the ids, in
    no fixed order: exact, and bit-equal on repeats, for integer vec
    (JAX's one caller passes pair counts); on other vec within an ulp of
    the f32 result and not bit-equal on repeats (ROADMAP C).  No path of
    the port calls this entry: its general loss sums its counts inside
    its own kernels.  Not differentiable."""
    if is_cpu(vec, "same_group_matvec"):
        return same_group_matvec_plain(groups, vec)
    dev, b = vec.device, vec.shape[0]
    _vectors(b, dev, vec=vec)
    lib = _lib()
    g = _groups(groups.reshape(-1), b, dev, lib)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scratch = _scratch(lib, _MATVEC, b, dev)
    rc = lib.group_matvec_f32(g.data_ptr(), vec.data_ptr(), b,
                              _ptr(scratch), out.data_ptr(), dev.index,
                              _build.stream_of(vec))
    check_rc(lib, rc, "same_group_matvec")
    same_group_matvec.launches += 1
    return out


same_group_matvec.launches = 0


def group_pair_counts_binary(groups: torch.Tensor, labels: torch.Tensor,
                             sample_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(B,) f32 ``pos * (tot - pos)`` over row i's group, pos the sum of
    mask * label and tot the sum of mask (the member count without a
    mask): the group's pair count for binary labels and a 0/1 mask (the
    caller's promise, unchecked).  groups (B,) int, labels and mask (B,)
    float32.  Not differentiable."""
    return _group_pair_counts_binary(groups, labels, sample_mask, "auto")


def _group_pair_counts_binary(groups: torch.Tensor, labels: torch.Tensor,
                              sample_mask: Optional[torch.Tensor],
                              path: str) -> torch.Tensor:
    """:func:`group_pair_counts_binary` on the kernel's ``path`` (a key of
    :data:`PATHS`; a CPU tensor takes the plain version whatever it is)."""
    if is_cpu(labels, "group_pair_counts_binary"):
        return group_pair_counts_binary_plain(groups, labels, sample_mask)
    dev, b = labels.device, labels.shape[0]
    _vectors(b, dev, labels=labels, sample_mask=sample_mask)
    lib = _lib()
    g = _groups(groups.reshape(-1), b, dev, lib)
    _check_path(b, path)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scratch = _scratch(lib, _BINARY, b, dev, PATHS[path])
    rc = lib.binary_counts_f32(g.data_ptr(), labels.data_ptr(),
                               _ptr(sample_mask), b, PATHS[path],
                               _ptr(scratch), out.data_ptr(), dev.index,
                               _build.stream_of(labels))
    check_rc(lib, rc, "group_pair_counts_binary")
    group_pair_counts_binary.launches += 1
    return out


group_pair_counts_binary.launches = 0


def pair_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                    groups: GroupLike, factor: float = 1.0,
                    occurrence_power: float = 0.0, *,
                    row_weights: Optional[torch.Tensor] = None,
                    sample_mask: Optional[torch.Tensor] = None,
                    wrong_order: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits, labels (B,) float32, groups as in the module docstring,
    row weights and mask (B,) float32 or None -> (loss_sum, n_pair,
    dlogits); f32 on the logits' device."""
    if is_cpu(logits, "pair_loss_sum"):
        return pair_loss_fused_plain(
            logits, labels, groups, factor, occurrence_power,
            row_weights=row_weights, sample_mask=sample_mask,
            wrong_order=wrong_order)
    dev, b = logits.device, logits.shape[0]
    _vectors(b, dev, logits=logits, labels=labels, row_weights=row_weights,
             sample_mask=sample_mask)
    lib = _lib()
    g = _groups(groups, b, dev, lib)
    _check_occurrence(g, occurrence_power, wrong_order)
    if b == 0:
        out = torch.zeros(2, dtype=torch.float32, device=dev)
        return out[0], out[1], torch.zeros(0, dtype=torch.float32, device=dev)
    # every element is written by the kernel's merge
    out = torch.empty(2, dtype=torch.float32, device=dev)
    dx = torch.empty(b, dtype=torch.float32, device=dev)
    scratch = _scratch(lib, _LOSS, b, dev)
    rc = lib.pair_loss_f32(logits.data_ptr(), labels.data_ptr(),
                           g.data_ptr(), g.shape[0], _ptr(row_weights),
                           _ptr(sample_mask), b, factor, occurrence_power,
                           int(wrong_order), scratch.data_ptr(),
                           out.data_ptr(), dx.data_ptr(), dev.index,
                           _build.stream_of(logits))
    check_rc(lib, rc, "pair_loss_sum")
    pair_loss_sum.launches += 1
    return out[0], out[1], dx


def pair_loss_general(logits: torch.Tensor, labels: torch.Tensor,
                      groups: GroupLike, factor: float = 1.0,
                      occurrence_power: float = -0.5, *,
                      sample_mask: Optional[torch.Tensor] = None,
                      wrong_order: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits, labels (B,) float32, groups as in the module docstring,
    mask (B,) float32 or None -> (loss_sum, n_pair, dlogits) of the
    general loss (:func:`pair_loss_general_plain`); f32 on the logits'
    device, one launch of ``pair_loss_sum``."""
    return _pair_loss_general(logits, labels, groups, factor,
                              occurrence_power, sample_mask, wrong_order,
                              "auto")


def _pair_loss_general(logits: torch.Tensor, labels: torch.Tensor,
                       groups: GroupLike, factor: float, power: float,
                       sample_mask: Optional[torch.Tensor],
                       wrong_order: bool, path: str
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pair_loss_general` on the kernel's ``path`` (a key of
    :data:`PATHS`: the one sort, or the composition of O(B^2) sweeps; a
    CPU tensor takes the plain version whatever it is)."""
    if is_cpu(logits, "pair_loss_sum"):
        return pair_loss_general_plain(logits, labels, groups, factor, power,
                                       sample_mask=sample_mask,
                                       wrong_order=wrong_order)
    dev, b = logits.device, logits.shape[0]
    _vectors(b, dev, logits=logits, labels=labels, sample_mask=sample_mask)
    lib = _lib()
    g = _groups(groups, b, dev, lib)
    _check_path(b, path)
    if b == 0:
        out = torch.zeros(2, dtype=torch.float32, device=dev)
        return out[0], out[1], torch.zeros(0, dtype=torch.float32, device=dev)
    # every element is written by the kernels' merge
    out = torch.empty(2, dtype=torch.float32, device=dev)
    dx = torch.empty(b, dtype=torch.float32, device=dev)
    scratch = _scratch(lib, _GENERAL, b, dev, PATHS[path])
    rc = lib.pair_loss_general_f32(
        logits.data_ptr(), labels.data_ptr(), g.data_ptr(), g.shape[0],
        _ptr(sample_mask), b, factor, power, int(wrong_order), PATHS[path],
        scratch.data_ptr(), out.data_ptr(), dx.data_ptr(), dev.index,
        _build.stream_of(logits))
    check_rc(lib, rc, "pair_loss_sum")
    pair_loss_sum.launches += 1
    return out[0], out[1], dx


class _PairLossSum(torch.autograd.Function):
    """(loss_sum, n_pair) of ``run(logits)`` -> (loss_sum, n_pair,
    dlogits): the forward stashes dlogits, the backward scales it."""

    @staticmethod
    def forward(ctx, logits, run):
        loss, cnt, dx = run(logits)
        ctx.save_for_backward(dx)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, g_cnt):
        (dx,) = ctx.saved_tensors
        return dx * g_loss, None


def pair_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                  groups: GroupLike, factor: float = 1.0,
                  occurrence_power: float = 0.0, *,
                  row_weights: Optional[torch.Tensor] = None,
                  sample_mask: Optional[torch.Tensor] = None,
                  wrong_order: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of weighted BPR pair losses, pair count); gradients flow to
    ``logits`` only, through the dlogits the forward computed (weights and
    masks are constants, as in JAX)."""
    return _PairLossSum.apply(logits, functools.partial(
        pair_loss_fused, labels=labels, groups=group_rows(groups),
        factor=factor, occurrence_power=occurrence_power,
        row_weights=row_weights, sample_mask=sample_mask,
        wrong_order=wrong_order))


pair_loss_sum.launches = 0


def pair_loss_general_sum(logits: torch.Tensor, labels: torch.Tensor,
                          groups: GroupLike, factor: float = 1.0,
                          occurrence_power: float = -0.5, *,
                          sample_mask: Optional[torch.Tensor] = None,
                          wrong_order: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the general loss's weighted BPR pair losses, pair count)
    (:func:`pair_loss_general`); gradients flow to ``logits`` only, the
    counts and weights being constants, as in JAX (``stop_gradient``,
    ``pairwise_kernel.py:451``, ``:457``)."""
    return _PairLossSum.apply(logits, functools.partial(
        pair_loss_general, labels=labels, groups=group_rows(groups),
        factor=factor, occurrence_power=occurrence_power,
        sample_mask=sample_mask, wrong_order=wrong_order))
