"""Conformer encoder blocks (conv-augmented transformer), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/conformer.py``, the first-party stand-in
for the SpeechBrain Conformer of the reference's SE recipe. Each block:

    x += ½·FFN(LN(x))
    x += MHSA(LN(x))            (RoPE positions, non-causal)
    x += ConvModule(LN(x))      (pointwise → GLU → depthwise k → LN → SiLU
                                 → pointwise)
    x += ½·FFN(LN(x));  x = LN(x)

The channel norm of the conv module is a LayerNorm, as in the reference.
LayerNorm takes the population variance (``jnp.var``), the attention is the
port's two products (:func:`.transformer.attention`), and every linear and
the depthwise conv run in exact fp32 (TF32 off), as the reference's
``Precision.HIGHEST``. The depthwise conv pads ``(k − 1) // 2`` zeros on
the left and the rest on the right.

Weights keep the reference's tree ``{"layers": [...]}``, key for key; the
depthwise ``conv.dw.w`` ``[k, 1, H]`` becomes ``[H, 1, k]`` (``groups =
H``) in the weight bridge (:func:`conformer_from_jax`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d, pad1d
from audiocodecs_tpu_torch.nn.transformer import (
    Linear,
    Norm,
    _linear,
    _norm,
    apply_rope,
    attention,
    rope_cos_sin,
)

__all__ = ["Conformer", "ConformerConfig", "apply_conformer",
           "conformer_from_jax", "init_conformer_params"]


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    hidden_size: int = 256
    num_layers: int = 4
    num_heads: int = 4
    ffn_mult: int = 4
    conv_kernel: int = 31
    eps: float = 1e-5
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _ffn(H: int, inner: int) -> nn.ModuleDict:
    return nn.ModuleDict({"in": Linear(H, inner, True),
                          "out": Linear(inner, H, True)})


class _ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        H = cfg.hidden_size
        self.pw1 = Linear(H, 2 * H, True)
        self.dw = Conv1d(1, H, cfg.conv_kernel)  # w [H, 1, k], groups = H
        self.norm = Norm(H, "layernorm")
        self.pw2 = Linear(H, H, True)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        H, F_ = cfg.hidden_size, cfg.hidden_size * cfg.ffn_mult
        self.ln_ff1, self.ff1 = Norm(H, "layernorm"), _ffn(H, F_)
        self.ln_attn = Norm(H, "layernorm")
        self.q, self.k = Linear(H, H, True), Linear(H, H, True)
        self.v, self.o = Linear(H, H, True), Linear(H, H, True)
        self.ln_conv, self.conv = Norm(H, "layernorm"), _ConvModule(cfg)
        self.ln_ff2, self.ff2 = Norm(H, "layernorm"), _ffn(H, F_)
        self.ln_out = Norm(H, "layernorm")


class Conformer(nn.Module):
    """``layers.<i>``; ``forward``: [B, T, H] → [B, T, H]."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(ConformerLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_conformer(self, x, self.cfg)


def _ln(x, p: Norm, eps: float):
    return _norm(x, p, "layernorm", eps)


def _ffn_apply(x, p: nn.ModuleDict):
    return _linear(F.silu(_linear(x, p["in"])), p["out"])


def _conv_module(x, p: _ConvModule, cfg: ConformerConfig):
    """The conv module on ``[B, T, H]``."""
    h = _linear(x, p.pw1)  # [B, T, 2H]
    a, b = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)).transpose(1, 2)  # GLU, [B, H, T]
    k = cfg.conv_kernel
    pad = (k - 1) // 2
    h = pad1d(h, pad, k - 1 - pad, mode="constant")
    h = conv1d(h, p.dw.w, p.dw.b, groups=cfg.hidden_size).transpose(1, 2)
    h = F.silu(_ln(h, p.norm, cfg.eps))
    return _linear(h, p.pw2)


def apply_conformer(model: Conformer, x: torch.Tensor,
                    cfg: ConformerConfig) -> torch.Tensor:
    """``[B, T, H]`` → ``[B, T, H]`` (non-causal)."""
    B, T, _ = x.shape
    cos, sin = rope_cos_sin(torch.arange(T, device=x.device), cfg.head_dim,
                            cfg.rope_theta)
    nh, hd = cfg.num_heads, cfg.head_dim
    for p in model.layers:
        x = x + 0.5 * _ffn_apply(_ln(x, p.ln_ff1, cfg.eps), p.ff1)
        h = _ln(x, p.ln_attn, cfg.eps)
        q = _linear(h, p.q).reshape(B, T, nh, hd)
        k = _linear(h, p.k).reshape(B, T, nh, hd)
        v = _linear(h, p.v).reshape(B, T, nh, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        a = attention(q, k, v)  # non-causal
        x = x + _linear(a.reshape(B, T, cfg.hidden_size), p.o)
        x = x + _conv_module(_ln(x, p.ln_conv, cfg.eps), p.conv, cfg)
        x = x + 0.5 * _ffn_apply(_ln(x, p.ln_ff2, cfg.eps), p.ff2)
        x = _ln(x, p.ln_out, cfg.eps)
    return x


def init_conformer_params(generator: torch.Generator, cfg: ConformerConfig,
                          prefix: str = "") -> dict:
    """Flat state dict of a :class:`Conformer` in the reference's
    distributions: linears N(0, 1/in) with zero biases, norms 1 and 0, the
    depthwise taps N(0, 0.05²) (the draws differ from ``jax.random``'s)."""
    H = cfg.hidden_size
    F_ = H * cfg.ffn_mult
    out = {}

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn(i, o, generator=generator) * i ** -0.5
        out[f"{name}.b"] = torch.zeros(o)

    def norm(name):
        out[f"{name}.g"] = torch.ones(H)
        out[f"{name}.b"] = torch.zeros(H)

    for li in range(cfg.num_layers):
        p = f"{prefix}layers.{li}"
        norm(f"{p}.ln_ff1")
        lin(f"{p}.ff1.in", H, F_)
        lin(f"{p}.ff1.out", F_, H)
        norm(f"{p}.ln_attn")
        for name in ("q", "k", "v", "o"):
            lin(f"{p}.{name}", H, H)
        norm(f"{p}.ln_conv")
        lin(f"{p}.conv.pw1", H, 2 * H)
        out[f"{p}.conv.dw.w"] = torch.randn(
            H, 1, cfg.conv_kernel, generator=generator) * 0.05
        out[f"{p}.conv.dw.b"] = torch.zeros(H)
        norm(f"{p}.conv.norm")
        lin(f"{p}.conv.pw2", H, H)
        norm(f"{p}.ln_ff2")
        lin(f"{p}.ff2.in", H, F_)
        lin(f"{p}.ff2.out", F_, H)
        norm(f"{p}.ln_out")
    return out


def conformer_from_jax(tree, cfg: ConformerConfig, device=None) -> Conformer:
    """The reference's ``{"layers": [...]}`` tree (numpy arrays) as a
    :class:`Conformer` on ``device``."""
    from audiocodecs_tpu_torch.params import from_jax_params

    model = Conformer(cfg)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    return model.to(device)
