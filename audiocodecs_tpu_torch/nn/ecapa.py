"""ECAPA-TDNN speaker tower (wespeaker's ``ECAPA_TDNN_GLOB_c512``), PyTorch.

Counterpart of ``audiocodecs_tpu/nn/ecapa.py``: BiCodec's speaker encoder
over 100-bin mels. In wespeaker's order:

* ``layer1``: conv k5 → ReLU → BatchNorm;
* ``layer2``–``layer4``: SE-Res2 blocks at dilations 2, 3, 4: a 1×1
  conv-ReLU-BN, the Res2 conv (8 groups of channels; the first seven run a
  carried conv-ReLU-BN cascade, each group added to the previous output,
  the last passes through), a 1×1 conv-ReLU-BN, squeeze-excitation (a
  128-wide bottleneck), added to the block's input;
* ``conv``: 1×1 over the three blocks' outputs concatenated (3·C) → ReLU;
* attentive statistics pooling with global context ([x, mean, std] a
  frame), BatchNorm, a linear to the embedding.

``return_frames`` also returns the three blocks' concatenated outputs a
frame, BiCodec's perceiver context. The BatchNorms run their inference
form (the running mean and variance). The convs are zero padded to keep
the length. Inside, the layout is PyTorch's ``[B, C, T]``; every product
and conv runs in exact fp32 (TF32 off). Weights keep the reference's names
(``layer2.in.conv`` …; ``in`` is reached with ``getattr``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d, exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear

__all__ = ["EcapaConfig", "Ecapa", "apply_ecapa", "init_ecapa_params"]


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    feat_dim: int = 100
    channels: int = 512
    embed_dim: int = 1024
    scale: int = 8
    attn_hidden: int = 128
    se_bottleneck: int = 128

    @property
    def cat_channels(self) -> int:
        return 3 * self.channels


class _BatchNorm(nn.Module):
    """Inference BatchNorm: gain ``g``, bias ``b``, the running ``mean``
    and ``var``."""

    def __init__(self, ch: int):
        super().__init__()
        for name in ("g", "b", "mean", "var"):
            setattr(self, name, nn.Parameter(torch.empty(ch)))


class _ConvReluBn(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv1d(cin, cout, k, bias=False)
        self.bn = _BatchNorm(cout)


class _Res2(nn.Module):
    def __init__(self, width: int, k: int, scale: int):
        super().__init__()
        self.convs = nn.ModuleList(Conv1d(width, width, k, bias=False)
                                   for _ in range(scale - 1))
        self.bns = nn.ModuleList(_BatchNorm(width) for _ in range(scale - 1))


class _SE(nn.Module):
    def __init__(self, ch: int, bottleneck: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(ch, bottleneck))
        self.b1 = nn.Parameter(torch.empty(bottleneck))
        self.w2 = nn.Parameter(torch.empty(bottleneck, ch))
        self.b2 = nn.Parameter(torch.empty(ch))


class _SERes2Block(nn.Module):
    def __init__(self, cfg: EcapaConfig, k: int):
        super().__init__()
        C = cfg.channels
        self.add_module("in", _ConvReluBn(C, C, 1))
        self.res2 = _Res2(C // cfg.scale, k, cfg.scale)
        self.out = _ConvReluBn(C, C, 1)
        self.se = _SE(C, cfg.se_bottleneck)


class Ecapa(nn.Module):
    """The tower's weights; :func:`apply_ecapa` runs it."""

    def __init__(self, cfg: EcapaConfig):
        super().__init__()
        A = cfg.cat_channels
        self.layer1 = _ConvReluBn(cfg.feat_dim, cfg.channels, 5)
        for name in ("layer2", "layer3", "layer4"):
            self.add_module(name, _SERes2Block(cfg, 3))
        self.conv = Conv1d(A, A, 1)
        self.attn1 = Linear(3 * A, cfg.attn_hidden, True)
        self.attn2 = Linear(cfg.attn_hidden, A, True)
        self.pool_bn = _BatchNorm(2 * A)
        self.linear = Linear(2 * A, cfg.embed_dim, True)


def _bn(x, p: _BatchNorm, eps: float = 1e-5):
    """Over the channels of ``[B, C, T]`` or ``[B, C]``."""
    scale = p.g * torch.rsqrt(p.var + eps)
    if x.dim() == 3:
        return (x - p.mean[:, None]) * scale[:, None] + p.b[:, None]
    return (x - p.mean) * scale + p.b


def _conv_relu_bn(x, p: _ConvReluBn, dilation: int = 1):
    span = (p.conv.w.shape[-1] - 1) * dilation
    x = F.pad(x, (span // 2, span - span // 2))
    return _bn(torch.relu(conv1d(x, p.conv.w, dilation=dilation)), p.bn)


def _res2(x, p: _Res2, dilation: int, scale: int):
    parts = x.chunk(scale, dim=1)
    outs, sp = [], None
    for i, (conv, bn) in enumerate(zip(p.convs, p.bns)):
        sp = parts[i] if sp is None else sp + parts[i]
        span = (conv.w.shape[-1] - 1) * dilation
        h = conv1d(F.pad(sp, (span // 2, span - span // 2)), conv.w,
                   dilation=dilation)
        sp = _bn(torch.relu(h), bn)
        outs.append(sp)
    outs.append(parts[-1])
    return torch.cat(outs, dim=1)


def _se(x, p: _SE):
    s = torch.mean(x, dim=-1)  # [B, C]
    with exact_fp32():
        s = torch.relu(torch.matmul(s, p.w1) + p.b1)
        s = torch.sigmoid(torch.matmul(s, p.w2) + p.b2)
    return x * s[..., None]


def _se_res2_block(x, p: _SERes2Block, dilation: int, scale: int):
    h = _conv_relu_bn(x, getattr(p, "in"))
    h = _conv_relu_bn(_res2(h, p.res2, dilation, scale), p.out)
    return x + _se(h, p.se)


def apply_ecapa(model: Ecapa, mel: torch.Tensor, cfg: EcapaConfig,
                return_frames: bool = False):
    """``[B, T, feat_dim]`` mel frames → the embedding ``[B, embed_dim]``
    (and with ``return_frames`` the frames ``[B, T, cat_channels]``)."""
    x1 = _conv_relu_bn(mel.transpose(1, 2), model.layer1)
    x2 = _se_res2_block(x1, model.layer2, 2, cfg.scale)
    x3 = _se_res2_block(x2, model.layer3, 3, cfg.scale)
    x4 = _se_res2_block(x3, model.layer4, 4, cfg.scale)
    frames = torch.cat([x2, x3, x4], dim=1)
    x = torch.relu(conv1d(frames, model.conv.w, model.conv.b)).transpose(1, 2)

    # attentive statistics pooling with global context, over [B, T, A]
    mu = torch.mean(x, dim=1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=1, keepdim=True)
    sg = torch.sqrt(torch.clamp(var, min=1e-7))
    ctx = torch.cat([x, mu.expand_as(x), sg.expand_as(x)], dim=-1)
    a = _linear(torch.tanh(_linear(ctx, model.attn1)), model.attn2)
    a = torch.softmax(a, dim=1)
    mean = torch.sum(a * x, dim=1)
    var = torch.sum(a * x * x, dim=1) - mean ** 2
    stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-7))], dim=-1)
    emb = _linear(_bn(stats, model.pool_bn), model.linear)
    if return_frames:
        return emb, frames.transpose(1, 2)
    return emb


def init_ecapa_params(generator: torch.Generator, cfg: EcapaConfig,
                      prefix: str = "") -> dict:
    """Random weights of :class:`Ecapa` as a flat state dict under
    ``prefix``, in the reference's distributions (convs N(0, 1/(k·cin)),
    bias-free but the post-concat conv's zero bias; linears N(0, 1/in) with
    zero biases; BatchNorms at gain 1, bias 0, mean 0, variance 1); the
    draws differ from the reference's."""
    C, A = cfg.channels, cfg.cat_channels
    out = {}

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator) * scale

    def conv(name, k, cin, cout):
        out[f"{prefix}{name}.w"] = randn(cout, cin, k, scale=(k * cin) ** -.5)

    def bn(name, ch):
        for leaf, v in (("g", 1.0), ("b", 0.0), ("mean", 0.0), ("var", 1.0)):
            out[f"{prefix}{name}.{leaf}"] = torch.full((ch,), v)

    def lin(name, i, o):
        out[f"{prefix}{name}.w"] = randn(i, o, scale=i ** -0.5)
        out[f"{prefix}{name}.b"] = torch.zeros(o)

    def crb(name, k, cin, cout):
        conv(f"{name}.conv", k, cin, cout)
        bn(f"{name}.bn", cout)

    crb("layer1", 5, cfg.feat_dim, C)
    w, S = C // cfg.scale, cfg.se_bottleneck
    for name in ("layer2", "layer3", "layer4"):
        crb(f"{name}.in", 1, C, C)
        for i in range(cfg.scale - 1):
            conv(f"{name}.res2.convs.{i}", 3, w, w)
            bn(f"{name}.res2.bns.{i}", w)
        crb(f"{name}.out", 1, C, C)
        out[f"{prefix}{name}.se.w1"] = randn(C, S, scale=C ** -0.5)
        out[f"{prefix}{name}.se.b1"] = torch.zeros(S)
        out[f"{prefix}{name}.se.w2"] = randn(S, C, scale=S ** -0.5)
        out[f"{prefix}{name}.se.b2"] = torch.zeros(C)
    conv("conv", 1, A, A)
    out[f"{prefix}conv.b"] = torch.zeros(A)
    lin("attn1", 3 * A, cfg.attn_hidden)
    lin("attn2", cfg.attn_hidden, A)
    bn("pool_bn", 2 * A)
    lin("linear", 2 * A, cfg.embed_dim)
    return out
