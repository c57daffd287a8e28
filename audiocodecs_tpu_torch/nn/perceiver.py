"""Perceiver resampler (learned queries cross-attending a sequence), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/perceiver.py``: BiCodec pools an
utterance's ECAPA frames into 32 global speaker latents. The context is
projected to the latents' width (``proj_context``, where the widths
differ); each block is pre-RMSNorm cross-attention whose keys and values
come from the normed latents *and* the context (the latents first), then a
pre-RMSNorm GEGLU feed-forward (``a · GELU(b)`` of the two halves, exact
GELU), each added to the latents; a final RMSNorm. RMSNorm is
``x / ‖x‖ · √d · g``.

Weights keep the reference's names (``latents``, ``blocks.<i>.attn.
{norm, q_w, kv_w, out_w}``, ``blocks.<i>.ff.{norm, w1, b1, w2, b2}``,
``norm``, ``proj_context``), applied as ``x @ w``. Every product runs in
exact fp32 (TF32 off); attention is :func:`..nn.transformer.attention`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear, attention

__all__ = ["PerceiverConfig", "Perceiver", "apply_perceiver",
           "init_perceiver_params"]


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    dim: int = 128
    depth: int = 2
    num_heads: int = 8
    head_dim: int = 64
    num_latents: int = 32
    dim_context: int = 1024
    ff_mult: int = 4

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ff_inner(self) -> int:
        return int(self.dim * self.ff_mult * 2 / 3)  # GEGLU's sizing


class _Attn(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        C, I = cfg.dim, cfg.inner_dim
        self.norm = nn.Parameter(torch.empty(C))
        self.q_w = nn.Parameter(torch.empty(C, I))
        self.kv_w = nn.Parameter(torch.empty(C, 2 * I))
        self.out_w = nn.Parameter(torch.empty(I, C))


class _FF(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        C, F_ = cfg.dim, cfg.ff_inner
        self.norm = nn.Parameter(torch.empty(C))
        self.w1 = nn.Parameter(torch.empty(C, 2 * F_))
        self.b1 = nn.Parameter(torch.empty(2 * F_))
        self.w2 = nn.Parameter(torch.empty(F_, C))
        self.b2 = nn.Parameter(torch.empty(C))


class _Block(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        self.attn = _Attn(cfg)
        self.ff = _FF(cfg)


class Perceiver(nn.Module):
    """The resampler's weights; :func:`apply_perceiver` runs it."""

    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(cfg.num_latents, cfg.dim))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.Parameter(torch.empty(cfg.dim))
        if cfg.dim_context != cfg.dim:
            self.proj_context = Linear(cfg.dim_context, cfg.dim, True)


def _rmsnorm(x, g):
    n = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    return n * (x.shape[-1] ** 0.5) * g


def _mm(x, w):
    with exact_fp32():
        return torch.matmul(x, w)


def _cross_attn(latents, ctx, p: _Attn, cfg: PerceiverConfig):
    B, N, _ = latents.shape
    H, D, I = cfg.num_heads, cfg.head_dim, cfg.inner_dim
    x = _rmsnorm(latents, p.norm)
    q = _mm(x, p.q_w).reshape(B, N, H, D)
    kv = _mm(torch.cat([x, ctx], dim=1), p.kv_w)  # the latents first
    k = kv[..., :I].reshape(B, -1, H, D)
    v = kv[..., I:].reshape(B, -1, H, D)
    o = attention(q, k, v, scale=D ** -0.5)
    return _mm(o.reshape(B, N, I), p.out_w)


def _geglu_ff(x, p: _FF):
    a, b = (_mm(_rmsnorm(x, p.norm), p.w1) + p.b1).chunk(2, dim=-1)
    return _mm(a * F.gelu(b, approximate="none"), p.w2) + p.b2


def apply_perceiver(model: Perceiver, ctx: torch.Tensor,
                    cfg: PerceiverConfig) -> torch.Tensor:
    """``ctx`` ``[B, T, dim_context]`` → latents ``[B, num_latents, dim]``."""
    if hasattr(model, "proj_context"):
        ctx = _linear(ctx, model.proj_context)
    latents = model.latents.expand(ctx.shape[0], -1, -1)
    for p in model.blocks:
        latents = latents + _cross_attn(latents, ctx, p.attn, cfg)
        latents = latents + _geglu_ff(latents, p.ff)
    return _rmsnorm(latents, model.norm)


def init_perceiver_params(generator: torch.Generator, cfg: PerceiverConfig,
                          prefix: str = "") -> dict:
    """Random weights of :class:`Perceiver` as a flat state dict under
    ``prefix``, in the reference's distributions (the latents N(0, 1),
    products N(0, 1/in), zero biases, unit norm gains); the draws differ
    from the reference's."""
    C, I, F_ = cfg.dim, cfg.inner_dim, cfg.ff_inner
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=generator) * shape[0] ** -0.5

    out[f"{prefix}latents"] = torch.randn((cfg.num_latents, C),
                                          generator=generator)
    for i in range(cfg.depth):
        p = f"{prefix}blocks.{i}"
        out[f"{p}.attn.norm"] = torch.ones(C)
        out[f"{p}.attn.q_w"] = randn(C, I)
        out[f"{p}.attn.kv_w"] = randn(C, 2 * I)
        out[f"{p}.attn.out_w"] = randn(I, C)
        out[f"{p}.ff.norm"] = torch.ones(C)
        out[f"{p}.ff.w1"] = randn(C, 2 * F_)
        out[f"{p}.ff.b1"] = torch.zeros(2 * F_)
        out[f"{p}.ff.w2"] = randn(F_, C)
        out[f"{p}.ff.b2"] = torch.zeros(C)
    out[f"{prefix}norm"] = torch.ones(C)
    if cfg.dim_context != cfg.dim:
        out[f"{prefix}proj_context.w"] = randn(cfg.dim_context, C)
        out[f"{prefix}proj_context.b"] = torch.zeros(C)
    return out
