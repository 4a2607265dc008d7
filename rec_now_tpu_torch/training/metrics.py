"""AUC / GAUC evaluation metrics.

Counterpart of ``rec_now_tpu/training/metrics.py`` (all of it).  The
device parts are plain PyTorch on the tensors' own device (no Pallas
kernel is involved in JAX); the host parts are copies of the JAX
package's numpy code.

* :func:`binary_auc` -- exact batch AUC by a rank sort (Mann-Whitney U).
* :func:`batch_gauc_stats` / :func:`batch_gauc` -- in-batch grouped AUC
  from (B, B) same-group (pos, neg) pairs.
* :class:`DeviceStreamingAUC` -- (2, K) bucketed score histograms on the
  device; O(1/K) tie error.
* :class:`DeviceGroupedAUC` -- corpus GAUC from (2 G, K) per-group score
  histograms on the device, reduced to (3, G) there.
* :class:`CorpusGroupIndexer` -- host-side group id -> dense slot map
  (exact dict, or the salted multiplicative hash, bit-exact in uint64).
* :class:`StreamingGAUC` -- exact corpus GAUC on the host.

The histogram updates add each sample's weight into its (row, bucket)
cell with ``index_add_``; the cells' sums are exact integers for unit
weights, so they equal JAX's segment sums.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from rec_now_tpu_torch.core.config import resolve_device


def binary_auc(labels: torch.Tensor, scores: torch.Tensor,
               sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC AUC via the rank statistic, ties counted half; 0.5 when
    degenerate.  labels (B,) 0/1, scores (B,), optional (B,) weights."""
    labels = labels.reshape(-1).to(torch.float32)
    scores = scores.reshape(-1)
    w = (torch.ones_like(labels) if sample_weight is None
         else sample_weight.reshape(-1).to(torch.float32))
    order = torch.argsort(scores)
    sorted_labels, sorted_w = labels[order], w[order]
    sorted_scores = scores[order]
    n = sorted_scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    neg_w = sorted_w * (1.0 - sorted_labels)
    cum_neg = torch.cumsum(neg_w, 0)                   # inclusive
    cum_neg_before = cum_neg - neg_w
    # each positive counts all strictly-lower negative weight plus half of
    # its tie group's
    ties = sorted_scores[1:] == sorted_scores[:-1]
    no = torch.zeros(1, dtype=torch.bool, device=scores.device)
    start = torch.cummax(torch.where(torch.cat([no, ties]), 0, idx), 0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(
        torch.cat([ties, no]), n - 1, idx), [0]), 0).values, [0])
    neg_below_group = cum_neg_before[start]
    group_tied_neg = cum_neg[end] - neg_below_group
    u = torch.sum(sorted_w * sorted_labels
                  * (neg_below_group + 0.5 * group_tied_neg))
    denom = torch.sum(w * labels) * torch.sum(w * (1.0 - labels))
    return torch.where(denom > 0, u / torch.where(denom > 0, denom, 1.0),
                       0.5)


def batch_gauc_stats(labels: torch.Tensor, scores: torch.Tensor,
                     group_ids: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(concordant-win sum, pair total) over same-group (pos, neg) pairs,
    ties counted half: the two sums a scanned eval accumulates."""
    labels = labels.reshape(-1).to(torch.float32)
    scores = scores.reshape(-1)
    g = group_ids.reshape(-1)
    pair = ((g[:, None] == g[None, :])
            & (labels[:, None] > labels[None, :])).to(torch.float32)
    s_i, s_j = scores[:, None], scores[None, :]
    concordant = ((s_i > s_j).to(torch.float32)
                  + 0.5 * (s_i == s_j).to(torch.float32))
    return torch.sum(pair * concordant), torch.sum(pair)


def batch_gauc(labels: torch.Tensor, scores: torch.Tensor,
               group_ids: torch.Tensor) -> torch.Tensor:
    """In-batch GAUC: pair-weighted mean of the groups' AUCs; 0.5 without
    a same-group (pos, neg) pair."""
    win, total = batch_gauc_stats(labels, scores, group_ids)
    return torch.where(total > 0, win / torch.where(total > 0, total, 1.0),
                       0.5)


def _buckets(logits: torch.Tensor, k: int) -> torch.Tensor:
    p = torch.sigmoid(logits.reshape(-1).to(torch.float32))
    return torch.clamp((p * k).to(torch.int64), 0, k - 1)


def _weights(labels: torch.Tensor, weights: Optional[torch.Tensor]):
    labels = labels.reshape(-1).to(torch.float32)
    w = (torch.ones_like(labels) if weights is None
         else weights.reshape(-1).to(torch.float32))
    return w * labels, w * (1.0 - labels)


class DeviceStreamingAUC:
    """Bucketed streaming AUC on the device: a (2, K) histogram of positive
    and negative weight by sigmoid-probability bucket; pairs in one bucket
    count half, so the error is O(1/K) (< 1e-3 at K = 4096).

    Args:
        num_buckets: K.
        device: where the histogram lives ("cuda" unless asked otherwise).
    """

    def __init__(self, num_buckets: int = 4096,
                 device: Union[str, torch.device] = "cuda"):
        self.k = int(num_buckets)
        self.hist = torch.zeros((2, self.k), dtype=torch.float32,
                                device=resolve_device(device))

    @staticmethod
    def accumulate(hist: torch.Tensor, labels: torch.Tensor,
                   logits: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Add one batch to a (2, K) histogram, in place; returns it."""
        k = hist.shape[1]
        b = _buckets(logits, k)
        pos, neg = _weights(labels, weights)
        flat = hist.view(-1)
        flat.index_add_(0, b, pos)
        flat.index_add_(0, b + k, neg)
        return hist

    def update(self, labels, logits, weights=None) -> None:
        """Accumulate one batch."""
        dev = self.hist.device
        self.accumulate(self.hist, torch.as_tensor(labels, device=dev),
                        torch.as_tensor(logits, device=dev),
                        None if weights is None
                        else torch.as_tensor(weights, device=dev))

    @staticmethod
    def auc_from_hist(hist: np.ndarray) -> float:
        """AUC from a (2, K) bucket histogram (host, O(K))."""
        pos, neg = np.asarray(hist, np.float64)
        neg_below = np.cumsum(neg) - neg
        u = float(np.sum(pos * (neg_below + 0.5 * neg)))
        denom = pos.sum() * neg.sum()
        return float(u / denom) if denom > 0 else 0.5

    def result(self) -> Dict[str, float]:
        """{'auc', 'num_pos', 'num_neg'}: one 2 K-float fetch."""
        hist = self.hist.cpu().numpy().astype(np.float64)
        return {"auc": self.auc_from_hist(hist),
                "num_pos": float(hist[0].sum()),
                "num_neg": float(hist[1].sum())}


class DeviceGroupedAUC:
    """Corpus GAUC on the device from per-group score histograms: a
    (2 G, K) histogram, rows [0, G) positive and [G, 2 G) negative,
    indexed by a host-assigned corpus slot (:class:`CorpusGroupIndexer`);
    :meth:`finish` reduces it to (3, G) on the device.  Per-group AUC has
    :class:`DeviceStreamingAUC`'s O(1/K) tie error; slots past G clamp
    into the last."""

    @staticmethod
    def init(num_groups: int, num_buckets: int,
             device: Union[str, torch.device] = "cuda") -> torch.Tensor:
        """A zero (2 G, K) histogram."""
        return torch.zeros((2 * num_groups, num_buckets),
                           dtype=torch.float32,
                           device=resolve_device(device))

    @staticmethod
    def accumulate(ghist: torch.Tensor, slots: torch.Tensor,
                   labels: torch.Tensor, logits: torch.Tensor,
                   num_buckets: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Add one batch in place (slots (B,) in [0, G), labels 0/1,
        logits, optional example weights, 0 = ignore); returns ghist."""
        k = num_buckets
        g = ghist.shape[0] // 2
        slots = torch.clamp(slots.reshape(-1).to(torch.int64), 0, g - 1)
        cell = slots * k + _buckets(logits, k)
        pos, neg = _weights(labels, weights)
        flat = ghist.view(-1)
        flat.index_add_(0, cell, pos)
        flat.index_add_(0, cell + g * k, neg)
        return ghist

    @staticmethod
    def finish(ghist: torch.Tensor) -> torch.Tensor:
        """(2 G, K) -> (3, G) per-group Mann-Whitney U numerator and
        positive / negative totals, on the histogram's device."""
        g = ghist.shape[0] // 2
        pos, neg = ghist[:g], ghist[g:]
        neg_below = torch.cumsum(neg, dim=1) - neg
        u = torch.sum(pos * (neg_below + 0.5 * neg), dim=1)
        return torch.stack([u, pos.sum(dim=1), neg.sum(dim=1)])

    @staticmethod
    def gauc_from_stats(stats: np.ndarray,
                        weight_by: str = "pairs") -> Dict[str, float]:
        """Host finish from (3, G) per-group stats."""
        u, n_pos, n_neg = np.asarray(stats, np.float64)
        denom = n_pos * n_neg
        valid = denom > 0
        auc_g = np.where(valid, u / np.where(valid, denom, 1.0), 0.0)
        w = denom if weight_by == "pairs" else n_pos + n_neg
        w = np.where(valid, w, 0.0)
        total_w = w.sum()
        return {
            "gauc": float((w * auc_g).sum() / total_w)
            if total_w > 0 else float("nan"),
            "num_groups": float(valid.sum()),
        }

    @staticmethod
    def gauc_from_hist(ghist: np.ndarray, num_buckets: int,
                       weight_by: str = "pairs") -> Dict[str, float]:
        """Host finish from the full (2 G, K) histogram."""
        h = np.asarray(ghist, np.float64)
        g = h.shape[0] // 2
        pos, neg = h[:g], h[g:]
        neg_below = np.cumsum(neg, axis=1) - neg             # (G, K)
        u = np.sum(pos * (neg_below + 0.5 * neg), axis=1)    # (G,)
        stats = np.stack([u, pos.sum(axis=1), neg.sum(axis=1)])
        return DeviceGroupedAUC.gauc_from_stats(stats, weight_by)


class CorpusGroupIndexer:
    """Host-side group id -> dense corpus slot for the device GAUC.

    Dict mode: each distinct group id takes the next slot, exact while the
    corpus has fewer than ``num_slots - num_slots // 8`` groups; later
    groups fold into the last ``num_slots // 8`` slots by hash (counted in
    ``overflowed``).  Hash mode: the salted multiplicative hash every
    process of a pod computes alike, collisions counted in ``overflowed``.
    """

    def __init__(self, num_slots: int, use_hash: bool = False):
        self.num_slots = int(num_slots)
        self.use_hash = bool(use_hash)
        self._map: Dict[int, int] = {}
        self.overflowed = 0
        self._collided: set = set()

    def assign(self, group_ids: np.ndarray) -> np.ndarray:
        """(B,) raw group ids -> (B,) dense slots in [0, num_slots)."""
        g = np.asarray(group_ids).reshape(-1)
        if self.use_hash:
            h = (g.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                 + np.uint64(0xD6E8FEB8)) >> np.uint64(13)
            slots = (h % np.uint64(self.num_slots)).astype(np.int64)
            uniq, first = np.unique(g, return_index=True)
            for gid, slot in zip(uniq.tolist(), slots[first].tolist()):
                prev = self._map.get(slot)
                if prev is None:
                    self._map[slot] = gid
                elif prev != gid and gid not in self._collided:
                    self._collided.add(gid)
                    self.overflowed += 1
            return slots
        cap = self.num_slots - max(1, self.num_slots // 8)
        uniq, inv = np.unique(g, return_inverse=True)
        slots = np.empty(uniq.shape, np.int64)
        for i, gid in enumerate(uniq.tolist()):
            slot = self._map.get(gid)
            if slot is None:
                if len(self._map) < cap:
                    slot = len(self._map)
                else:   # overflow: hash into the reserved tail slots
                    self.overflowed += 1
                    slot = cap + hash(gid) % (self.num_slots - cap)
                self._map[gid] = slot
            slots[i] = slot
        return slots[inv]

    def seen(self) -> np.ndarray:
        """Hash mode: every distinct group id assigned so far, sorted."""
        return np.array(sorted(set(self._map.values()) | self._collided),
                        np.int64)


class StreamingGAUC:
    """Exact corpus GAUC on the host: buffers (group, label, score) and
    computes, at :meth:`result`, the pair- (or impression-) weighted mean
    of the per-group AUCs over groups with both classes."""

    def __init__(self, weight_by: str = "pairs"):
        if weight_by not in ("pairs", "impressions"):
            raise ValueError(weight_by)
        self.weight_by = weight_by
        self._groups: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._scores: List[np.ndarray] = []

    def update(self, group_ids, labels, scores):
        """Buffer one batch (numpy arrays or CPU tensors)."""
        self._groups.append(np.asarray(group_ids).reshape(-1))
        self._labels.append(np.asarray(labels).reshape(-1))
        self._scores.append(np.asarray(scores).reshape(-1))

    @staticmethod
    def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
        order = np.argsort(scores)
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(scores) + 1)
        # average ranks over ties
        sorted_scores = scores[order]
        _, inv, counts = np.unique(sorted_scores, return_inverse=True,
                                   return_counts=True)
        cum = np.cumsum(counts)
        avg = (cum - (counts - 1) / 2.0)
        ranks[order] = avg[inv]
        n_pos = labels.sum()
        n_neg = len(labels) - n_pos
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        u = ranks[labels > 0].sum() - n_pos * (n_pos + 1) / 2.0
        return float(u / (n_pos * n_neg))

    def result(self) -> Dict[str, float]:
        """{'gauc', 'auc', 'num_groups'} over everything buffered."""
        g = np.concatenate(self._groups)
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        auc_all = self._auc(y, s)
        total_w = 0.0
        acc = 0.0
        num_groups = 0
        for gid in np.unique(g):
            m = g == gid
            yl, sl = y[m], s[m]
            n_pos = yl.sum()
            n_neg = len(yl) - n_pos
            if n_pos == 0 or n_neg == 0:
                continue
            w = (n_pos * n_neg if self.weight_by == "pairs"
                 else len(yl))
            acc += w * self._auc(yl, sl)
            total_w += w
            num_groups += 1
        gauc = float(acc / total_w) if total_w > 0 else float("nan")
        return {"gauc": gauc, "auc": float(auc_all),
                "num_groups": float(num_groups)}
