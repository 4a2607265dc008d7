"""Synthetic Criteo-style data (26 sparse + 13 dense features).

A copy of ``rec_now_tpu/training/data.py`` (numpy only), kept here so
the port imports nothing of the JAX package; it gives byte-identical
batches from the same seed.  A host-side numpy generator with a *planted* ground-truth model so AUC is
learnable and comparable across frameworks: the label depends linearly on
the dense features plus low-rank interactions of per-field latent
factors, passed through a sigmoid.  Group ids (user ids) follow a zipf
distribution so in-batch pairwise/listwise grouping has realistic
multi-sample groups.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Batch(NamedTuple):
    """One host batch (numpy)."""
    dense: np.ndarray        # (B, num_dense) float32
    sparse_ids: np.ndarray   # (B, num_sparse) int32 raw per-field ids
    labels: np.ndarray       # (B,) float32 0/1
    group_ids: np.ndarray    # (B,) int32 user/group id
    cvr_labels: np.ndarray   # (B,) float32 0/1 (conversion; multi-task)
    domain_idx: np.ndarray   # (B,) int32 serving domain in [0, 4)


class SyntheticCriteo:
    """Deterministic synthetic Criteo-small stream."""

    def __init__(self, num_dense: int = 13, num_sparse: int = 26,
                 rows_per_field: int = 100_000, latent_dim: int = 4,
                 num_users: int = 5_000, zipf_a: float = 1.3,
                 seed: int = 0):
        self.num_dense = num_dense
        self.num_sparse = num_sparse
        self.rows_per_field = rows_per_field
        self.num_users = num_users
        self.zipf_a = zipf_a
        rng = np.random.RandomState(seed)
        # planted model
        self.dense_w = rng.randn(num_dense).astype(np.float32) * 0.5
        self.latent = rng.randn(num_sparse, rows_per_field, latent_dim
                                ).astype(np.float32) * 0.3
        self.field_w = rng.randn(num_sparse).astype(np.float32)
        self.user_bias = rng.randn(num_users).astype(np.float32) * 0.5
        self._seed = seed

    def batches(self, batch_size: int, num_batches: int,
                seed: int = 1) -> Iterator[Batch]:
        """Yield ``num_batches`` batches of ``batch_size``."""
        rng = np.random.RandomState(seed)
        for _ in range(num_batches):
            yield self.sample(batch_size, rng)

    def sample(self, batch_size: int,
               rng: np.random.RandomState) -> Batch:
        """Draw one batch from the planted model."""
        b = batch_size
        dense = rng.randn(b, self.num_dense).astype(np.float32)
        ids = (rng.zipf(self.zipf_a, size=(b, self.num_sparse))
               % self.rows_per_field).astype(np.int32)
        users = (rng.zipf(self.zipf_a, size=b) % self.num_users
                 ).astype(np.int32)
        domains = rng.randint(0, 4, size=b).astype(np.int32)

        # planted logit: dense linear + field-weighted latent factor sums
        # + pairwise latent interactions + user bias
        lat = self.latent[np.arange(self.num_sparse)[None, :], ids]
        # lat: (B, F, latent)
        first = (lat.sum(-1) * self.field_w[None, :]).sum(-1)     # (B,)
        summed = lat.sum(1)                                       # (B, L)
        inter = 0.5 * ((summed ** 2).sum(-1)
                       - (lat ** 2).sum(-1).sum(-1))              # (B,)
        logit = (dense @ self.dense_w + first + 0.3 * inter
                 + self.user_bias[users])
        logit = (logit - logit.mean()) / (logit.std() + 1e-6)
        p = 1.0 / (1.0 + np.exp(-1.5 * logit + 1.0))
        labels = (rng.rand(b) < p).astype(np.float32)
        # conversions: subset of clicks with a related but distinct logit
        p_cvr = 1.0 / (1.0 + np.exp(-1.0 * logit - 0.5))
        cvr = (labels * (rng.rand(b) < p_cvr)).astype(np.float32)
        return Batch(dense=dense, sparse_ids=ids, labels=labels,
                     group_ids=users, cvr_labels=cvr, domain_idx=domains)
