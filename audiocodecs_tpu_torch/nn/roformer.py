"""RoFormer blocks (the BS-RoFormer lineage), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/roformer.py``: X-Codec 2.0's vocoder
backbone, MagiCodec's encoder and decoder (gated attention, GELU
feed-forward) and StableCodec's towers (gateless, SwiGLU). A block:

* pre-RMSNorm (``x / ‖x‖ · √d · g``) on both branches;
* attention: a fused ``to_qkv`` (no bias), rotary embedding on the first
  ``rope_dim`` dims of each head's q and k (interleaved-pair rotate-half,
  θ = 10000), optional per-head sigmoid gates from a ``gates`` linear,
  ``out_w`` (no bias);
* feed-forward: linear → GELU (erf) → linear, or SwiGLU.

Weights keep the reference's names and layouts (``attn.qkv_w [C, 3C]``,
``ffn.w1 [C, F]`` …, applied as ``x @ w``), so the weight bridge copies
them unchanged. Every product runs in a
:class:`..nn.layers.DecodeForm`'s precision: exact fp32 (TF32 off) by
default, the reference's ``_precision()`` in an encoder and in a decoder
at its default; or, for a decoder built with fp32 activations at one bf16
pass, on bf16-rounded operands with fp32 sums, the reference's decoder
under ``ACX_DEC_CONV_PRECISION=default`` (``conv_role("decoder")``).
Attention is :func:`..nn.transformer.attention`: two batched products, the
scores and the softmax in fp32, not ``scaled_dot_product_attention``. The
reference computes it outside any Pallas kernel, so this is plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import DecodeForm
from audiocodecs_tpu_torch.nn.transformer import Linear, attention

__all__ = ["RoformerConfig", "Roformer", "apply_roformer",
           "init_roformer_params"]


@dataclasses.dataclass(frozen=True)
class RoformerConfig:
    dim: int = 1024
    depth: int = 12
    num_heads: int = 16
    ffn_mult: int = 4
    rope_dim: int = 64  # rotary dims per head
    rope_theta: float = 10000.0
    use_gates: bool = True  # per-head sigmoid output gates (BS-RoFormer)
    ffn: str = "gelu"  # "gelu" (BS-RoFormer) | "swiglu" (stable-audio-tools)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


class _FFN(nn.Module):
    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        C, F_ = cfg.dim, cfg.dim * cfg.ffn_mult
        self.w1 = nn.Parameter(torch.empty(C, F_))
        if cfg.ffn == "swiglu":
            self.wg = nn.Parameter(torch.empty(C, F_))
        else:
            self.b1 = nn.Parameter(torch.empty(F_))
            self.b2 = nn.Parameter(torch.empty(C))
        self.w2 = nn.Parameter(torch.empty(F_, C))
        self.kind = cfg.ffn

    def forward(self, h, form: DecodeForm = DecodeForm()):
        if self.kind == "swiglu":
            h = F.silu(form.matmul(h, self, "w1")) * form.matmul(h, self,
                                                                  "wg")
            return form.matmul(h, self, "w2")
        h = F.gelu(form.matmul(h, self, "w1") + self.b1)
        return form.matmul(h, self, "w2") + self.b2


class _Attention(nn.Module):
    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        C = cfg.dim
        self.qkv_w = nn.Parameter(torch.empty(C, 3 * C))
        self.out_w = nn.Parameter(torch.empty(C, C))
        self.gates = (Linear(C, cfg.num_heads, bias=True) if cfg.use_gates
                      else None)


class _Block(nn.Module):
    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        self.attn_norm = nn.Parameter(torch.empty(cfg.dim))
        self.attn = _Attention(cfg)
        self.ffn_norm = nn.Parameter(torch.empty(cfg.dim))
        self.ffn = _FFN(cfg)


class Roformer(nn.Module):
    """``blocks.<i>``; ``forward``: [B, T, dim] → [B, T, dim]."""

    def __init__(self, cfg: RoformerConfig):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor,
                form: DecodeForm = DecodeForm()) -> torch.Tensor:
        return apply_roformer(self, x, self.cfg, form)


def _rmsnorm(x, g):
    n = x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)
    return n * (x.shape[-1] ** 0.5) * g


@functools.lru_cache(maxsize=16)
def _phases_np(T: int, rope_dim: int, theta: float):
    """[T, rope_dim] cos and sin in float64 numpy, each frequency repeated
    for the interleaved pairs, then rounded to float32: the reference's
    values bit for bit."""
    freqs = 1.0 / (theta ** (np.arange(0, rope_dim, 2, dtype=np.float64)
                             / rope_dim))
    ang = np.arange(T, dtype=np.float64)[:, None] * freqs[None, :]
    ang = np.repeat(ang, 2, axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _rope_phases(T: int, cfg: RoformerConfig, device):
    cos, sin = _phases_np(T, cfg.rope_dim, cfg.rope_theta)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _rotate_half(x):
    """Interleaved pairs (x0, x1) → (−x1, x0)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def _apply_rope(x, cos, sin):
    """``x``: [B, T, H, D]; rotate the first ``rope_dim`` dims of D."""
    r = cos.shape[-1]
    xr, xp = x[..., :r], x[..., r:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([xr * c + _rotate_half(xr) * s, xp], dim=-1)


def _attention(x, p: _Attention, cfg: RoformerConfig, cos, sin,
               form: DecodeForm):
    B, T, C = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    qkv = form.matmul(x, p, "qkv_w").reshape(B, T, 3, H, D)
    q, k, v = qkv.unbind(dim=2)  # [B, T, H, D]
    o = attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v,
                  scale=D ** -0.5,
                  operand=form.operand if form.one_pass else None)
    if p.gates is not None:
        gates = form.matmul(x, p.gates, "w") + p.gates.b
        o = o * torch.sigmoid(gates)[..., None]
    return form.matmul(o.reshape(B, T, H * D), p, "out_w")


def apply_roformer(model: Roformer, x: torch.Tensor, cfg: RoformerConfig,
                   form: DecodeForm = DecodeForm()) -> torch.Tensor:
    """``[B, T, dim]`` → ``[B, T, dim]`` through ``model``'s blocks, every
    product in ``form``'s precision (its activations stay fp32)."""
    cos, sin = _rope_phases(x.shape[1], cfg, x.device)
    for p in model.blocks:
        x = x + _attention(_rmsnorm(x, p.attn_norm), p.attn, cfg, cos, sin,
                           form)
        x = x + p.ffn(_rmsnorm(x, p.ffn_norm), form)
    return x


def init_roformer_params(generator: torch.Generator, cfg: RoformerConfig,
                         prefix: str = "") -> dict:
    """Random weights of :class:`Roformer` as a flat state dict under
    ``prefix``, in the reference's distributions (linears N(0, 1/in), zero
    biases, unit norm gains); the draws differ from ``jax.random``'s."""
    C, F_ = cfg.dim, cfg.dim * cfg.ffn_mult
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=generator) * shape[0] ** -0.5

    for i in range(cfg.depth):
        p = f"{prefix}blocks.{i}"
        out[f"{p}.attn_norm"] = torch.ones(C)
        out[f"{p}.attn.qkv_w"] = randn(C, 3 * C)
        out[f"{p}.attn.out_w"] = randn(C, C)
        if cfg.use_gates:
            out[f"{p}.attn.gates.w"] = randn(C, cfg.num_heads)
            out[f"{p}.attn.gates.b"] = torch.zeros(cfg.num_heads)
        out[f"{p}.ffn_norm"] = torch.ones(C)
        out[f"{p}.ffn.w1"] = randn(C, F_)
        if cfg.ffn == "swiglu":
            out[f"{p}.ffn.wg"] = randn(C, F_)
        else:
            out[f"{p}.ffn.b1"] = torch.zeros(F_)
            out[f"{p}.ffn.b2"] = torch.zeros(C)
        out[f"{p}.ffn.w2"] = randn(F_, C)
    return out
