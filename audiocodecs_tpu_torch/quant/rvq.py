"""Residual vector quantization (RVQ).

Counterpart of ``audiocodecs_tpu/quant/rvq.py``: ``rvq_encode`` and the
flat-gather ``rvq_decode`` (serving), ``rvq_quantize`` (encode with the
straight-through decode) and ``rvq_quantize_stats`` (the EMA statistics of
training). Codebooks are ``[K, C, H]``.
"""

from __future__ import annotations

import torch

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["rvq_encode", "rvq_decode", "rvq_quantize",
           "rvq_quantize_stats"]


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


def rvq_quantize(x: torch.Tensor, codebooks: torch.Tensor,
                 num_codebooks: int | None = None):
    """Encode and the straight-through decode in one pass → (toks
    ``[B, N, K]``, qfeats ``[B, N, H]``)."""
    K = codebooks.shape[0] if num_codebooks is None else num_codebooks
    residual = x
    q = torch.zeros_like(x)
    toks = []
    for k in range(K):
        idx = vq_encode(residual, codebooks[k])
        stage = vq_decode(idx, codebooks[k])
        toks.append(idx)
        residual = residual - stage
        q = q + stage
    return torch.stack(toks, dim=-1), q


def rvq_quantize_stats(x: torch.Tensor, codebooks: torch.Tensor,
                       num_codebooks: int | None = None):
    """:func:`rvq_quantize` plus, per stage, the sufficient statistics of
    exponential-moving-average codebook updates: one-hot assignment counts,
    the sums of the assigned stage-input residuals, and the residuals
    themselves (for dead-code restarts), all detached.

    Returns ``(toks [B,N,K], q [B,N,H], counts [K,C], sums [K,C,H],
    residuals [K,B·N,H])``. The sums are an fp32 product over the one-hot
    matrix (``[C, B·N] @ [B·N, H]``) and the counts its column sums, as in
    the reference, not scatters.
    """
    K = codebooks.shape[0] if num_codebooks is None else num_codebooks
    C = codebooks.shape[1]
    residual = x
    q = torch.zeros_like(x)
    toks, counts, sums, res_stack = [], [], [], []
    for k in range(K):
        idx = vq_encode(residual, codebooks[k])
        r = residual.detach().reshape(-1, residual.shape[-1])
        onehot = torch.nn.functional.one_hot(idx.reshape(-1), C).to(x.dtype)
        counts.append(onehot.sum(dim=0))
        with exact_fp32():
            sums.append(onehot.T @ r)
        res_stack.append(r)
        stage = vq_decode(idx, codebooks[k])
        toks.append(idx)
        residual = residual - stage
        q = q + stage
    return (torch.stack(toks, dim=-1), q, torch.stack(counts),
            torch.stack(sums), torch.stack(res_stack))
