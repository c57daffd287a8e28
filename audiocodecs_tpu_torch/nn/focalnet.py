"""1-D focal modulation blocks (FocalNet-style), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/focalnet.py``: FocalCodec's compressor
and decompressor. A block is pre-LayerNorm focal modulation and a
pre-LayerNorm GELU MLP, each added to its input. Focal modulation: a
linear ``f`` splits into a query, a context and L + 1 level gates; the
context passes through L depthwise convs of growing kernels (3, 5, …, zero
padded to keep the length, exact GELU after each), each level's output
weighted by its gate and summed, plus the GELU of the last level's mean
over time under the last gate; a linear ``h`` of the sum multiplies the
query, and ``proj`` maps it out.

Weights keep the reference's names (``blocks.<i>.ln1``, ``f``,
``focal_convs.<l>``, ``h``, ``proj``, ``ln2``, ``mlp1``, ``mlp2``); the
depthwise convs are :class:`..nn.layers.Conv1d` (``[C, 1, k]`` here,
``[k, 1, C]`` in the reference). Every product and conv runs in exact fp32
(TF32 off).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, _linear, _norm

__all__ = ["FocalConfig", "FocalBlocks", "apply_focal_blocks",
           "init_focal_params"]


@dataclasses.dataclass(frozen=True)
class FocalConfig:
    dim: int = 768
    num_blocks: int = 4
    focal_levels: int = 2
    focal_window: int = 3
    mlp_ratio: float = 4.0
    eps: float = 1e-5

    @property
    def hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)


class _Block(nn.Module):
    def __init__(self, cfg: FocalConfig):
        super().__init__()
        C, L = cfg.dim, cfg.focal_levels
        self.ln1 = Norm(C, "layernorm")
        self.f = Linear(C, 2 * C + L + 1, True)
        self.focal_convs = nn.ModuleList(
            Conv1d(1, C, cfg.focal_window + 2 * lv, bias=False)
            for lv in range(L))
        self.h = Linear(C, C, True)
        self.proj = Linear(C, C, True)
        self.ln2 = Norm(C, "layernorm")
        self.mlp1 = Linear(C, cfg.hidden, True)
        self.mlp2 = Linear(cfg.hidden, C, True)


class FocalBlocks(nn.Module):
    """``blocks.<i>``; ``forward``: [B, T, dim] → [B, T, dim]."""

    def __init__(self, cfg: FocalConfig):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_focal_blocks(self, x, self.cfg)


def _gelu(x):
    return F.gelu(x, approximate="none")


def _focal_modulation(x, p: _Block, cfg: FocalConfig):
    """Focal modulation of ``[B, T, C]``."""
    C, L = cfg.dim, cfg.focal_levels
    q, ctx, gates = _linear(x, p.f).split([C, C, L + 1], dim=-1)
    ctx = ctx.transpose(1, 2)  # [B, C, T] for the depthwise convs
    agg = 0.0
    for lv, conv in enumerate(p.focal_convs):
        k = conv.w.shape[-1]
        ctx = _gelu(conv1d(F.pad(ctx, (k // 2, k - 1 - k // 2)), conv.w,
                           groups=C))
        agg = agg + ctx.transpose(1, 2) * gates[..., lv: lv + 1]
    glob = _gelu(torch.mean(ctx, dim=-1, keepdim=True)).transpose(1, 2)
    agg = agg + glob * gates[..., L: L + 1]
    return _linear(q * _linear(agg, p.h), p.proj)


def apply_focal_blocks(model: FocalBlocks, x: torch.Tensor,
                       cfg: FocalConfig) -> torch.Tensor:
    """``[B, T, dim]`` through ``model``'s blocks."""
    for p in model.blocks:
        x = x + _focal_modulation(_norm(x, p.ln1, "layernorm", cfg.eps), p,
                                  cfg)
        h = _gelu(_linear(_norm(x, p.ln2, "layernorm", cfg.eps), p.mlp1))
        x = x + _linear(h, p.mlp2)
    return x


def init_focal_params(generator: torch.Generator, cfg: FocalConfig,
                      prefix: str = "") -> dict:
    """Random weights of :class:`FocalBlocks` as a flat state dict under
    ``prefix``, in the reference's distributions (linears N(0, 1/in) with
    zero biases, the depthwise convs N(0, 0.05²), norms 1 and 0); the draws
    differ from the reference's."""
    C = cfg.dim
    out = {}

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=generator) * i ** -.5
        out[f"{name}.b"] = torch.zeros(o)

    for bi in range(cfg.num_blocks):
        p = f"{prefix}blocks.{bi}"
        for name in ("ln1", "ln2"):
            out[f"{p}.{name}.g"] = torch.ones(C)
            out[f"{p}.{name}.b"] = torch.zeros(C)
        lin(f"{p}.f", C, 2 * C + cfg.focal_levels + 1)
        for lv in range(cfg.focal_levels):
            out[f"{p}.focal_convs.{lv}.w"] = torch.randn(
                (C, 1, cfg.focal_window + 2 * lv), generator=generator) * 0.05
        lin(f"{p}.h", C, C)
        lin(f"{p}.proj", C, C)
        lin(f"{p}.mlp1", C, cfg.hidden)
        lin(f"{p}.mlp2", cfg.hidden, C)
    return out
