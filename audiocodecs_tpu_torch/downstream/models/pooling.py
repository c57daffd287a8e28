"""Codebook-axis pooling layers.

Counterpart of ``audiocodecs_tpu/downstream/models/pooling.py`` (the
reference's pooling trio, ``downstream/models/pooling.py:26-81``): collapse
the K codebook axis of ``[B, N, K, H]`` features to ``[B, N, H]`` by
attention, a learned linear mix, or softmax-weighted channel mixing.
Parameters are dicts of tensors in the reference package's layout; every
product runs with TF32 off (the reference's attentional sum is
``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = [
    "attentional_pooling",
    "linear_pooling",
    "weighted_pooling",
    "init_attentional_pooling",
    "init_linear_pooling",
    "init_weighted_pooling",
]


def attentional_pooling(params, x: torch.Tensor) -> torch.Tensor:
    """Two-layer MLP attention scorer over the K axis: softmax_K(W₂·relu(
    W₁x+b₁)) weights, then the weighted sum."""
    with exact_fp32():
        h = torch.einsum("bnkh,hd->bnkd", x, params["w1"]) + params["b1"]
        scores = torch.einsum("bnkd,d->bnk", torch.relu(h), params["w2"])
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bnk,bnkh->bnh", w, x)


def linear_pooling(params, x: torch.Tensor) -> torch.Tensor:
    """Learned linear combination over K (no bias; identity when K == 1)."""
    if x.shape[-2] == 1:
        return x[..., 0, :]
    with exact_fp32():
        y = torch.einsum("bnkh,k->bnh", x, params["w"])
    if "b" in params:  # kept for checkpoints saved before the bias removal
        y = y + params["b"]
    return y


def weighted_pooling(params, x: torch.Tensor,
                     channel_idx: int | None = None) -> torch.Tensor:
    """Softmax-normalised per-codebook scalar weights; ``channel_idx``
    instead selects one codebook."""
    if channel_idx is not None:
        return x[..., channel_idx, :]
    w = torch.softmax(params["logits"], dim=-1)
    with exact_fp32():
        return torch.einsum("bnkh,k->bnh", x, w)


def init_attentional_pooling(generator: torch.Generator, dim: int,
                             hidden: int | None = None):
    """The reference's distributions (the draws differ from
    ``jax.random``'s)."""
    hidden = hidden or dim
    return {
        "w1": torch.randn(dim, hidden, generator=generator) * dim**-0.5,
        "b1": torch.zeros(hidden),
        "w2": torch.randn(hidden, generator=generator) * hidden**-0.5,
    }


def init_linear_pooling(generator: torch.Generator, num_codebooks: int):
    return {"w": torch.full((num_codebooks,), 1.0 / num_codebooks)}


def init_weighted_pooling(generator: torch.Generator, num_codebooks: int):
    return {"logits": torch.zeros(num_codebooks)}
