"""Finite Scalar Quantization (FSQ).

Counterpart of ``audiocodecs_tpu/quant/fsq.py``, used by NanoCodec (grouped
FSQ), X-Codec 2.0 (one FSQ behind linear projections) and StableCodec (a
residual FSQ ladder). Each latent dimension is rounded on its own small
grid of ``levels[i]`` points, so the codebook is implicit and a token is a
mixed-radix number over the per-dimension digits: elementwise work, no
nearest-neighbour search.

``torch.round`` rounds half to even, as ``jnp.round`` does, so a latent
that lands on an exact half-step rounds the reference's way. Tokens are
int64, their mixed-radix sum formed in integers (the zoo's largest
lattice has 4⁸ = 65,536 codes; the reference sums digits in float).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "fsq_bound",
    "fsq_quantize",
    "fsq_codes_to_indices",
    "fsq_indices_to_codes",
    "fsq_implicit_codebook",
]


def _levels(levels, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(levels, dtype=like.dtype, device=like.device)


def _basis(levels) -> list:
    """Mixed-radix place values ``[1, L0, L0·L1, …]``."""
    return [math.prod(levels[:i]) for i in range(len(levels))]


def fsq_bound(z: torch.Tensor, levels, eps: float = 1e-3) -> torch.Tensor:
    """Bound ``z`` (``[..., D]``) into the lattice's range through tanh."""
    lv = _levels(levels, z)
    half_l = (lv - 1) * (1 + eps) / 2
    offset = torch.where(torch.remainder(lv, 2) == 0, 0.5, 0.0).to(z.dtype)
    shift = torch.atanh(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels) -> torch.Tensor:
    """Round the bounded latents to grid points, normalised to ``[-1, 1]``
    (half to even)."""
    q = torch.round(fsq_bound(z, levels))
    half_width = torch.floor_divide(_levels(levels, z), 2)
    return q / half_width


def fsq_codes_to_indices(codes: torch.Tensor, levels) -> torch.Tensor:
    """Normalised grid codes ``[..., D]`` → flat mixed-radix index
    ``[...]`` (int64)."""
    half_width = torch.floor_divide(_levels(levels, codes), 2)
    digits = codes * half_width + half_width  # 0 .. L-1, to within an ulp
    basis = torch.tensor(_basis(levels), dtype=torch.int64,
                         device=codes.device)
    return (torch.round(digits).to(torch.int64) * basis).sum(dim=-1)


def fsq_indices_to_codes(indices: torch.Tensor, levels) -> torch.Tensor:
    """Flat index ``[...]`` → normalised grid codes ``[..., D]`` (float32)."""
    dev = indices.device
    basis = torch.tensor(_basis(levels), dtype=torch.int64, device=dev)
    lv = torch.tensor(levels, dtype=torch.int64, device=dev)
    digits = torch.remainder(
        torch.floor_divide(indices.to(torch.int64)[..., None], basis), lv)
    half_width = torch.floor_divide(lv, 2).to(torch.float32)
    return (digits.to(torch.float32) - half_width) / half_width


def fsq_implicit_codebook(levels) -> np.ndarray:
    """The full ``[prod(levels), D]`` implicit codebook (float32 numpy), for
    the ``embs()`` surface."""
    total = math.prod(levels)
    idx = np.arange(total, dtype=np.int64)
    basis = np.asarray(_basis(levels), dtype=np.int64)
    lv = np.asarray(levels, dtype=np.int64)
    digits = (idx[:, None] // basis) % lv
    half_width = (lv // 2).astype(np.float64)
    return ((digits - half_width) / half_width).astype(np.float32)
