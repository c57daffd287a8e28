"""Residual vector quantization (RVQ), serving path.

Counterpart of ``audiocodecs_tpu/quant/rvq.py`` (``rvq_encode`` and the
flat-gather ``rvq_decode``). Codebooks are ``[K, C, H]``.
"""

from __future__ import annotations

import torch

from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["rvq_encode", "rvq_decode"]


def rvq_encode(x: torch.Tensor, codebooks: torch.Tensor,
               num_codebooks: int | None = None) -> torch.Tensor:
    """``x``: [B, N, H], ``codebooks``: [K, C, H] → tokens [B, N, K]."""
    K = codebooks.shape[0] if num_codebooks is None else num_codebooks
    residual = x
    toks = []
    for k in range(K):
        idx = vq_encode(residual, codebooks[k])
        toks.append(idx)
        residual = residual - vq_decode(idx, codebooks[k])
    return torch.stack(toks, dim=-1)


def rvq_decode(toks: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Tokens [B, N, K] → quantized features [B, N, H]: one gather into the
    flattened ``[K·C, H]`` table, then one sum over the K stages."""
    K, C, H = codebooks.shape
    flat = codebooks.reshape(K * C, H)
    offsets = torch.arange(toks.shape[-1], device=toks.device,
                           dtype=toks.dtype) * C
    return flat[toks + offsets].sum(dim=-2)
