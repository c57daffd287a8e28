"""Euclidean vector quantization as one matmul and an argmax.

Counterpart of ``audiocodecs_tpu/quant/vq.py``: the nearest codeword is
``argmax(2·x·Eᵀ − ‖e‖²)`` in fp32 (TF32 off); the ``‖x‖²`` term is constant
across codewords and dropped. ``torch.argmax`` returns the first maximal
index, so ties go to the lowest codeword, as in the reference.
"""

from __future__ import annotations

import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["vq_encode", "vq_decode"]


def vq_encode(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``x``: [..., H]; ``codebook``: [C, H] → int64 indices [...]."""
    with exact_fp32():
        score = 2.0 * torch.matmul(x, codebook.T) - torch.sum(
            codebook * codebook, dim=-1)
    return torch.argmax(score, dim=-1)


def vq_decode(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Indices [...] → codewords [..., H]."""
    return codebook[indices]
