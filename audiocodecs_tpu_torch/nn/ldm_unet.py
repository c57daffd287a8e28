"""Latent-diffusion UNet (CompVis ``openaimodel.UNetModel``), PyTorch, NCHW.

Counterpart of ``audiocodecs_tpu/nn/ldm_unet.py``, weight-compatible with
its param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`.
SemantiCodec's decoder runs DDIM over it, cross-attending to the quantized
AudioMAE token features.

* ``timestep_embedding``: ``cat([cos, sin])`` in float32 → ``time_embed``
  (linear, SiLU, linear);
* ``input_blocks``: the input conv, then per level ``num_res_blocks`` ×
  [ResBlock (the time embedding added FiLM-style after its first conv; a
  1×1 skip where the channels change), SpatialTransformer at the attention
  resolutions], a stride-2 pad-1 Downsample between levels; every block's
  output pushed on the skip stack;
* ``middle``: ResBlock, SpatialTransformer, ResBlock;
* ``output_blocks``: mirrored, each taking one skip by channel concat, a
  nearest-2× Upsample with its conv at a level's end;
* ``out``: GN → SiLU → conv.

A SpatialTransformer is GN (eps 1e-6) → 1×1 ``proj_in`` → over the H·W
positions per block: LN · self-attention, LN · cross-attention on the
context, LN · GEGLU feed-forward (value half first, gate half second, exact
GELU) → 1×1 ``proj_out``, plus its input. Heads are ``C //
num_head_channels``. The ResBlocks' and ``out``'s group norms take eps
1e-5, the layer norms eps 1e-5 in float32.

Every tensor follows the dtype of ``time_embed.l0.w`` in the reference;
here that is the ``dtype`` argument (the weights cast to it once): float32,
or bfloat16 in SemantiCodec's serving tier, where the norms' statistics and
the softmax stay float32. Float32 runs with TF32 off. The convs and
products are library calls, as the reference leaves them to XLA: in bf16
cuDNN convs; in float32 each conv is an unfold and one cuBLAS product
(:func:`_conv`), because cuDNN's heuristics take FFT algorithms for the
fp32 3×3 convs on the 256 × 16 latent: 594 against 100 ms a call for the
8 windows' CFG batch on the H100, and an output a quarter of its largest
value off this form's, which the CPU path holds
(``tools/time_ldm_unet.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv2d, exact_fp32, param_as
from audiocodecs_tpu_torch.nn.ldm_vae import (
    GroupNorm,
    conv2d,
    group_norm,
    init_conv2d,
    init_norm,
    stats_dtype,
    swish,
    upsample2x,
)
from audiocodecs_tpu_torch.nn.transformer import Linear

__all__ = ["UNet", "UNetConfig", "apply_unet", "init_unet_params",
           "timestep_embedding"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 8
    model_channels: int = 128
    num_res_blocks: int = 2
    attention_resolutions: tuple = (8, 4, 2)  # in downsample factors
    channel_mult: tuple = (1, 2, 3, 5)
    num_head_channels: int = 32
    context_dim: int = 768
    transformer_depth: int = 1

    @property
    def emb_dim(self) -> int:
        return 4 * self.model_channels


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """``t`` [B] → ``cat([cos, sin])`` [B, dim] in float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


# ----------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# ----------------------------------------------------------------------- #


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_norm, self.in_conv = GroupNorm(cin), Conv2d(cin, cout, 3, 3)
        self.emb = Linear(emb_dim, cout, bias=True)
        self.out_norm = GroupNorm(cout)
        self.out_conv = Conv2d(cout, cout, 3, 3)
        if cin != cout:
            self.skip = Conv2d(cin, cout, 1, 1)


class CrossAttention(nn.Module):
    """``to_q`` [dim, dim], ``to_k``/``to_v`` [context_dim, dim] (bare
    leaves, no bias) and ``to_out`` (a linear with bias)."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.to_q = nn.Parameter(torch.empty(dim, dim))
        self.to_k = nn.Parameter(torch.empty(context_dim, dim))
        self.to_v = nn.Parameter(torch.empty(context_dim, dim))
        self.to_out = Linear(dim, dim, bias=True)


class GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Linear(dim, dim * 8, bias=True)
        self.out = Linear(dim * 4, dim, bias=True)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim)
        self.attn2 = CrossAttention(dim, context_dim)
        self.ff = GEGLU(dim)
        self.norm1, self.norm2, self.norm3 = (GroupNorm(dim)
                                              for _ in range(3))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, cfg: UNetConfig):
        super().__init__()
        self.norm = GroupNorm(ch)
        self.proj_in = Conv2d(ch, ch, 1, 1)
        self.blocks = nn.ModuleList(TransformerBlock(ch, cfg.context_dim)
                                    for _ in range(cfg.transformer_depth))
        self.proj_out = Conv2d(ch, ch, 1, 1)


class Block(nn.Module):
    """One entry of ``input_blocks``/``output_blocks``: whichever of
    ``conv``, ``res``, ``attn``, ``down`` and ``up`` it has, applied in
    that order."""

    def __init__(self, **parts: nn.Module):
        super().__init__()
        for name in ("conv", "res", "attn", "down", "up"):
            if name in parts:
                setattr(self, name, parts[name])


class TimeEmbed(nn.Module):
    def __init__(self, mc: int, emb_dim: int):
        super().__init__()
        self.l0 = Linear(mc, emb_dim, bias=True)
        self.l2 = Linear(emb_dim, emb_dim, bias=True)


class Middle(nn.Module):
    def __init__(self, ch: int, cfg: UNetConfig):
        super().__init__()
        self.res1 = ResBlock(ch, ch, cfg.emb_dim)
        self.attn = SpatialTransformer(ch, cfg)
        self.res2 = ResBlock(ch, ch, cfg.emb_dim)


class Out(nn.Module):
    def __init__(self, ch: int, cout: int):
        super().__init__()
        self.norm, self.conv = GroupNorm(ch), Conv2d(ch, cout, 3, 3)


def _plan(cfg: UNetConfig):
    """The reference's init walk: the input blocks after the first conv
    and the output blocks, each as (cin, cout, attention?, resampling:
    "down", "up" or ""), the middle's width and the last width."""
    mc, ds, ch = cfg.model_channels, 1, cfg.model_channels
    skips, inputs, outputs = [mc], [], []
    for i, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            inputs.append((ch, mult * mc, ds in cfg.attention_resolutions,
                           ""))
            ch = mult * mc
            skips.append(ch)
        if i != len(cfg.channel_mult) - 1:
            inputs.append((ch, ch, False, "down"))
            skips.append(ch)
            ds *= 2
    mid = ch
    for i, mult in reversed(list(enumerate(cfg.channel_mult))):
        for j in range(cfg.num_res_blocks + 1):
            cin = ch + skips.pop()
            ch = mult * mc
            up = "up" if i and j == cfg.num_res_blocks else ""
            outputs.append((cin, ch, ds in cfg.attention_resolutions, up))
            if up:
                ds //= 2
    return inputs, mid, outputs, ch


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        mc = cfg.model_channels
        inputs, mid, outputs, last = _plan(cfg)
        self.time_embed = TimeEmbed(mc, cfg.emb_dim)

        def block(cin, cout, attn, resample):
            if resample == "down":
                return Block(down=Conv2d(cin, cout, 3, 3))
            parts = {"res": ResBlock(cin, cout, cfg.emb_dim)}
            if attn:
                parts["attn"] = SpatialTransformer(cout, cfg)
            if resample:
                parts[resample] = Conv2d(cout, cout, 3, 3)
            return Block(**parts)

        self.input_blocks = nn.ModuleList(
            [Block(conv=Conv2d(cfg.in_channels, mc, 3, 3))]
            + [block(*b) for b in inputs])
        self.middle = Middle(mid, cfg)
        self.output_blocks = nn.ModuleList(block(*b) for b in outputs)
        self.out = Out(last, cfg.out_channels)


# ----------------------------------------------------------------------- #
# Functions
# ----------------------------------------------------------------------- #


def _conv(x: torch.Tensor, conv: Conv2d, *, stride: int = 1,
          padding: int = 1) -> torch.Tensor:
    """The UNet's conv: in bf16 :func:`..nn.ldm_vae.conv2d` (cuDNN); in
    float32 (or wider) an unfold of the zero-padded input and one product
    with the ``[Cout, Cin·kh·kw]`` weight (cuBLAS, TF32 off), then the
    bias."""
    if x.dtype == torch.bfloat16:
        return conv2d(x, conv, stride=stride, padding=padding)
    B, C, H, W = x.shape
    w = param_as(conv, "w", x.dtype)
    Co, _, kh, kw = w.shape
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    if (kh, kw, stride, padding) == (1, 1, 1, 0):
        cols = x.reshape(B, C, H * W)
    else:
        cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    with exact_fp32():
        y = torch.matmul(w.reshape(Co, -1), cols)
    return (y + param_as(conv, "b", x.dtype)[:, None]).reshape(B, Co, Ho, Wo)


def _linear(x: torch.Tensor, p: Linear) -> torch.Tensor:
    """``x @ w + b`` in ``x``'s dtype (the product rounded, then the bias
    added, as the reference's)."""
    w, b = param_as(p, "w", x.dtype), param_as(p, "b", x.dtype)
    with exact_fp32():
        return torch.matmul(x, w) + b


def _layer_norm(x: torch.Tensor, p: GroupNorm, eps: float = 1e-5):
    hi = stats_dtype(x)
    y = F.layer_norm(x.to(hi), (x.shape[-1],), p.scale.to(hi),
                     p.bias.to(hi), eps)
    return y.to(x.dtype)


def _res_block(p: ResBlock, x: torch.Tensor, emb: torch.Tensor):
    h = _conv(swish(group_norm(x, p.in_norm, eps=1e-5)), p.in_conv)
    h = h + _linear(swish(emb), p.emb)[:, :, None, None]
    h = _conv(swish(group_norm(h, p.out_norm, eps=1e-5)), p.out_conv)
    if hasattr(p, "skip"):
        x = _conv(x, p.skip, padding=0)
    return x + h


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """[B, N, D] each → [B, Nq, D]: scores scaled in q's dtype, the softmax
    in float32 cast back, as the reference's."""
    B, Nq, D = q.shape
    dh = D // heads
    q = q.reshape(B, Nq, heads, dh).transpose(1, 2)
    k = k.reshape(B, -1, heads, dh).permute(0, 2, 3, 1)
    v = v.reshape(B, -1, heads, dh).transpose(1, 2)
    with exact_fp32():
        scores = torch.matmul(q, k) * (dh ** -0.5)
        attn = torch.softmax(scores.to(stats_dtype(scores)),
                             dim=-1).to(q.dtype)
        out = torch.matmul(attn, v)  # [B, heads, Nq, dh]
    return out.transpose(1, 2).reshape(B, Nq, D)


def _cross_attention(p: CrossAttention, x, context, heads: int):
    dt = x.dtype
    with exact_fp32():
        q = torch.matmul(x, param_as(p, "to_q", dt))
        k = torch.matmul(context, param_as(p, "to_k", dt))
        v = torch.matmul(context, param_as(p, "to_v", dt))
    return _linear(_attention(q, k, v, heads), p.to_out)


def _geglu(p: GEGLU, x: torch.Tensor) -> torch.Tensor:
    h, gate = torch.chunk(_linear(x, p.proj), 2, dim=-1)
    return _linear(h * F.gelu(gate), p.out)


def _spatial_transformer(p: SpatialTransformer, x, context, heads: int):
    B, C, H, W = x.shape
    h = _conv(group_norm(x, p.norm, eps=1e-6), p.proj_in, padding=0)
    h = h.reshape(B, C, H * W).transpose(1, 2)
    for blk in p.blocks:
        n1 = _layer_norm(h, blk.norm1)
        h = h + _cross_attention(blk.attn1, n1, n1, heads)
        ctx = context if context is not None else h
        h = h + _cross_attention(blk.attn2, _layer_norm(h, blk.norm2), ctx,
                                 heads)
        h = h + _geglu(blk.ff, _layer_norm(h, blk.norm3))
    h = h.transpose(1, 2).reshape(B, C, H, W)
    return x + _conv(h, p.proj_out, padding=0)


def _apply_block(p: Block, h, emb, context, cfg: UNetConfig):
    if hasattr(p, "conv"):
        h = _conv(h, p.conv)
    if hasattr(p, "res"):
        h = _res_block(p.res, h, emb)
    if hasattr(p, "attn"):
        h = _spatial_transformer(p.attn, h, context,
                                 h.shape[1] // cfg.num_head_channels)
    if hasattr(p, "down"):
        h = _conv(h, p.down, stride=2, padding=1)
    if hasattr(p, "up"):
        h = _conv(upsample2x(h), p.up)
    return h


def apply_unet(model: UNet, x: torch.Tensor, t: torch.Tensor,
               context: Optional[torch.Tensor], cfg: UNetConfig,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` [B, in_ch, H, W] latents, ``t`` [B] timesteps, ``context``
    [B, N, context_dim] → eps [B, out_ch, H, W], all in ``dtype``."""
    te = model.time_embed
    emb = _linear(swish(_linear(
        timestep_embedding(t, cfg.model_channels).to(dtype), te.l0)), te.l2)
    h = x.to(dtype)
    if context is not None:
        context = context.to(dtype)
    hs = []
    for p in model.input_blocks:
        h = _apply_block(p, h, emb, context, cfg)
        hs.append(h)
    mid = model.middle
    h = _res_block(mid.res1, h, emb)
    h = _spatial_transformer(mid.attn, h, context,
                             h.shape[1] // cfg.num_head_channels)
    h = _res_block(mid.res2, h, emb)
    for p in model.output_blocks:
        h = _apply_block(p, torch.cat([h, hs.pop()], dim=1), emb, context,
                         cfg)
    h = swish(group_norm(h, model.out.norm, eps=1e-5))
    return _conv(h, model.out.conv)


# ----------------------------------------------------------------------- #
# Init (random weights from an explicit generator)
# ----------------------------------------------------------------------- #


def init_unet_params(generator: torch.Generator, cfg: UNetConfig,
                     prefix: str = "") -> dict:
    """Flat state dict of a :class:`UNet` in the reference's distributions
    (linears and convs N(0, 1/fan_in), zero biases, norms 1 and 0); the
    draws differ from ``jax.random``'s."""
    out, g = {}, generator

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=g) * i ** -0.5
        out[f"{name}.b"] = torch.zeros(o)

    def res(name, cin, cout):
        init_norm(out, f"{name}.in_norm", cin)
        init_conv2d(out, g, f"{name}.in_conv", cin, cout, 3)
        lin(f"{name}.emb", cfg.emb_dim, cout)
        init_norm(out, f"{name}.out_norm", cout)
        init_conv2d(out, g, f"{name}.out_conv", cout, cout, 3)
        if cin != cout:
            init_conv2d(out, g, f"{name}.skip", cin, cout, 1)

    def xattn(name, dim, cdim):
        out[f"{name}.to_q"] = torch.randn((dim, dim), generator=g) * dim ** -.5
        for leaf in ("to_k", "to_v"):
            out[f"{name}.{leaf}"] = (torch.randn((cdim, dim), generator=g)
                                     * cdim ** -0.5)
        lin(f"{name}.to_out", dim, dim)

    def st(name, ch):
        init_norm(out, f"{name}.norm", ch)
        init_conv2d(out, g, f"{name}.proj_in", ch, ch, 1)
        for d in range(cfg.transformer_depth):
            pre = f"{name}.blocks.{d}"
            xattn(f"{pre}.attn1", ch, ch)
            xattn(f"{pre}.attn2", ch, cfg.context_dim)
            lin(f"{pre}.ff.proj", ch, ch * 8)
            lin(f"{pre}.ff.out", ch * 4, ch)
            for n in ("norm1", "norm2", "norm3"):
                init_norm(out, f"{pre}.{n}", ch)
        init_conv2d(out, g, f"{name}.proj_out", ch, ch, 1)

    def block(name, cin, cout, attn, resample):
        if resample == "down":
            init_conv2d(out, g, f"{name}.down", cin, cout, 3)
            return
        res(f"{name}.res", cin, cout)
        if attn:
            st(f"{name}.attn", cout)
        if resample:
            init_conv2d(out, g, f"{name}.{resample}", cout, cout, 3)

    mc = cfg.model_channels
    inputs, mid, outputs, last = _plan(cfg)
    lin("time_embed.l0", mc, cfg.emb_dim)
    lin("time_embed.l2", cfg.emb_dim, cfg.emb_dim)
    init_conv2d(out, g, "input_blocks.0.conv", cfg.in_channels, mc, 3)
    for i, b in enumerate(inputs):
        block(f"input_blocks.{i + 1}", *b)
    res("middle.res1", mid, mid)
    st("middle.attn", mid)
    res("middle.res2", mid, mid)
    for i, b in enumerate(outputs):
        block(f"output_blocks.{i}", *b)
    init_norm(out, "out.norm", last)
    init_conv2d(out, g, "out.conv", last, cfg.out_channels, 3)
    return {prefix + k: v for k, v in out.items()}
