"""Target attention over a user's behavior history.

Counterpart of ``rec_now_tpu/rec_block/attention.py``:

* :func:`attention_by_dot_product` -- dot-product target attention,
  optionally with negative scores clamped to zero.
* :class:`DNNAttention` -- DIN-style attention: an MLP over [history,
  target] (``Dense`` layers ``layer{i}``, as ``convert`` maps Flax's
  names; a last layer of width 1 is added when ``dnn_dims`` does not end
  in 1), sigmoid scores, and an optional (B, L) mask of valid positions.
* :func:`attention_by_dnn` -- the functional form.

Symbols: B batch, L history length, D embedding dim.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (get_activation, make_linear,
                                           resolve_device)


def attention_by_dot_product(user_emb: torch.Tensor, doc_emb: torch.Tensor,
                             filter_neg: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """History (B, L, D) and target (B, D) -> (the score-weighted sum of
    the history (B, D), the score sum (B, 1))."""
    score = (user_emb * doc_emb[:, None, :]).sum(dim=2, keepdim=True)
    if filter_neg:
        score = torch.clamp_min(score, 0.0)                # (B, L, 1)
    attn_mat = (user_emb * score).sum(dim=1)               # (B, D)
    return attn_mat, score.squeeze(2).sum(dim=1, keepdim=True)


class DNNAttention(nn.Module):
    """DIN-style DNN attention: MLP([history, target]) -> sigmoid scores.
    ``emb_dim`` is D; the MLP takes 2 D."""

    def __init__(self, emb_dim: int, dnn_dims: Sequence[int],
                 generator: torch.Generator,
                 dnn_activation: Optional[str] = "relu",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        dims = list(dnn_dims)
        if dims[-1] != 1:
            dims.append(1)
        self.num_layers = len(dims)
        self.activation = get_activation(dnn_activation)
        fan_in = 2 * emb_dim
        for i, dim in enumerate(dims):
            setattr(self, f"layer{i}",
                    make_linear(fan_in, dim, device, generator))
            fan_in = dim

    def forward(self, user_emb: torch.Tensor, doc_emb: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """History (B, L, D), target (B, D), optional (B, L) validity ->
        (weighted history sum (B, D), score sum (B, 1))."""
        x = torch.cat([user_emb, doc_emb[:, None, :].expand_as(user_emb)],
                      dim=-1)                              # (B, L, 2D)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = self.activation(x)
        score = torch.sigmoid(x)                           # (B, L, 1)
        if mask is not None:
            score = score * mask[..., None].to(score.dtype)
        attn_mat = (user_emb * score).sum(dim=1)           # (B, D)
        return attn_mat, score.squeeze(2).sum(dim=1, keepdim=True)


def attention_by_dnn(user_emb: torch.Tensor, doc_emb: torch.Tensor,
                     dnn_dims: Sequence[int],
                     dnn_activation: Optional[str] = "relu",
                     *, generator: Optional[torch.Generator] = None,
                     module: Optional[DNNAttention] = None):
    """The functional form: builds a :class:`DNNAttention` on the inputs'
    device (from ``generator``, or a generator seeded 0, as JAX's
    ``PRNGKey(0)`` default) unless ``module`` is given, and applies it.

    Returns ``(attn_mat, attn_score_sum, module)``: JAX returns the Flax
    ``params`` third; the port returns the module, which holds them
    (``module.state_dict()``) and is passed back as ``module`` to reuse
    them."""
    if module is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        module = DNNAttention(user_emb.shape[-1], dnn_dims, generator,
                              dnn_activation, device=user_emb.device)
    attn_mat, score_sum = module(user_emb, doc_emb)
    return attn_mat, score_sum, module
