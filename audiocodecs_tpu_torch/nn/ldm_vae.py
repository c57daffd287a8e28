"""AutoencoderKL (the CompVis latent-diffusion VAE), PyTorch, NCHW.

Counterpart of ``audiocodecs_tpu/nn/ldm_vae.py``, weight-compatible with
its param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`
(2-D conv weights ``[kh, kw, Cin, Cout]`` there, ``[Cout, Cin, kh, kw]``
here). SemantiCodec's decode chain denoises in this VAE's latent space and
decodes latents to a 64-bin mel with :func:`apply_vae_decoder`.

* ``ResnetBlock``: GN (32 groups, eps 1e-6) → swish → conv3×3 → GN →
  swish → conv3×3, a 1×1 ``nin_shortcut`` where the channels change.
* ``AttnBlock``: one head of self-attention over the H·W positions (4,096
  at the decoder's middle block at full width), 1×1 q/k/v/proj.
* Decoder: ``conv_in`` → mid (block, attn, block) → each level
  (``ch_mult`` reversed): ``num_res_blocks + 1`` blocks and a nearest-2×
  upsample with its conv → ``norm_out`` → swish → ``conv_out``.
* Encoder: the mirror, each downsample a stride-2 conv after one row and
  one column of zeros at the bottom and the right; it returns (mean,
  logvar).

The audio layout is the reference's transposed to NCHW: a mel ``[B, 1, T,
M]`` (time as the height, mel bins as the width; the reference's is ``[B,
T, M, 1]``).

Numerics follow the reference's: everything computes in the dtype of the
input and the weights (float32, or bfloat16 in SemantiCodec's serving
tier, whose weights are cast once, :func:`..nn.layers.param_as`); the
group norm takes its statistics and its affine in float32 and casts back;
the attention's softmax runs in float32 and is cast to q's dtype; a conv's
bias is added after the conv's output is rounded, as the reference's
``conv + b``. Float32 runs with TF32 off. The convs and products are
library calls (cuDNN, cuBLAS), as the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv2d, exact_fp32, param_as

__all__ = [
    "AUDIOLDM_VAE",
    "AutoencoderKL",
    "GroupNorm",
    "VAEConfig",
    "apply_vae_decoder",
    "apply_vae_encoder",
    "conv2d",
    "group_norm",
    "init_conv2d",
    "init_norm",
    "init_vae_params",
    "stats_dtype",
    "swish",
    "upsample2x",
]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 1
    out_channels: int = 1
    ch: int = 128
    ch_mult: tuple = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 8
    embed_dim: int = 8

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


# AudioLDM / SemantiCodec first-stage VAE: mel 64 bins → latent [T/4, 16, 8]
AUDIOLDM_VAE = VAEConfig()


# ----------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# ----------------------------------------------------------------------- #


class GroupNorm(nn.Module):
    """A norm's ``scale`` and ``bias`` [C] (the group norms here, and the
    UNet's layer norms, under the reference's names)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin), Conv2d(cin, cout, 3, 3)
        self.norm2, self.conv2 = GroupNorm(cout), Conv2d(cout, cout, 3, 3)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1, 1)


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = (Conv2d(c, c, 1, 1) for _ in range(3))
        self.proj_out = Conv2d(c, c, 1, 1)


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)


class Level(nn.Module):
    """One resolution: its blocks and its resampling conv (``downsample``
    in the encoder, ``upsample`` in the decoder), if it has one."""

    def __init__(self, chans: list, resample: str = ""):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(a, b)
                                   for a, b in zip(chans, chans[1:]))
        if resample:
            setattr(self, resample, Conv2d(chans[-1], chans[-1], 3, 3))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        L = len(cfg.ch_mult)
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, 3)
        ch, levels = cfg.ch, []
        for i, m in enumerate(cfg.ch_mult):
            chans = [ch] + [cfg.ch * m] * cfg.num_res_blocks
            levels.append(Level(chans, "downsample" if i != L - 1 else ""))
            ch = chans[-1]
        self.down = nn.ModuleList(levels)
        self.mid = Mid(ch)
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv2d(ch, 2 * cfg.z_channels, 3, 3)


class Decoder(nn.Module):
    """Levels stored innermost first, the order they are applied."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, 3)
        self.mid = Mid(ch)
        levels = []
        for i in reversed(range(len(cfg.ch_mult))):
            chans = [ch] + [cfg.ch * cfg.ch_mult[i]] * (cfg.num_res_blocks
                                                        + 1)
            levels.append(Level(chans, "upsample" if i else ""))
            ch = chans[-1]
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(ch)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, 3)


class AutoencoderKL(nn.Module):
    """``encoder``, ``decoder``, ``quant_conv`` and ``post_quant_conv``,
    the reference's tree."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, 1)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, 1)


# ----------------------------------------------------------------------- #
# Functions
# ----------------------------------------------------------------------- #


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of a norm's statistics and a softmax: float32, or
    ``x``'s where that is wider (a float64 reference run)."""
    return torch.promote_types(x.dtype, torch.float32)


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)``, each rounded in ``x``'s dtype as the
    reference's."""
    return x * torch.sigmoid(x)


def group_norm(x: torch.Tensor, p: GroupNorm, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the channels of ``[B, C, ...]``: ``min(groups, C)``
    groups of contiguous channels, population variance, statistics and
    affine in float32 (:func:`stats_dtype`), the output in ``x``'s
    dtype."""
    g, hi = min(groups, x.shape[1]), stats_dtype(x)
    y = F.group_norm(x.to(hi), g, p.scale.to(hi), p.bias.to(hi), eps)
    return y.to(x.dtype)


def conv2d(x: torch.Tensor, conv: Conv2d, *, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """Zero-padded conv of ``[B, Cin, H, W]`` in ``x``'s dtype (weights
    cast to it); the bias added after the conv's output, as the
    reference's."""
    w, b = param_as(conv, "w", x.dtype), param_as(conv, "b", x.dtype)
    if x.dtype == torch.float32:
        with exact_fp32():
            return F.conv2d(x, w, b, stride=stride, padding=padding)
    return F.conv2d(x, w, None, stride=stride,
                    padding=padding) + b[:, None, None]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× on both spatial axes (the reference's ``jnp.repeat``)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def resnet_block(p: ResnetBlock, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(swish(group_norm(x, p.norm1)), p.conv1)
    h = conv2d(swish(group_norm(h, p.norm2)), p.conv2)
    if hasattr(p, "nin_shortcut"):
        x = conv2d(x, p.nin_shortcut, padding=0)
    return x + h


def attn_block(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """One head over the H·W positions; the softmax in float32, cast to
    q's dtype."""
    B, C, H, W = x.shape
    h = group_norm(x, p.norm)
    q, k, v = (conv2d(h, c, padding=0).reshape(B, C, H * W)
               for c in (p.q, p.k, p.v))
    with exact_fp32():
        scores = torch.matmul(q.transpose(1, 2), k) * (C ** -0.5)
        attn = torch.softmax(scores.to(stats_dtype(scores)),
                             dim=-1).to(q.dtype)
        h = torch.matmul(v, attn.transpose(1, 2))  # [B, C, HW]
    return x + conv2d(h.reshape(B, C, H, W), p.proj_out, padding=0)


def _mid(p: Mid, h: torch.Tensor) -> torch.Tensor:
    h = resnet_block(p.block_1, h)
    h = attn_block(p.attn_1, h)
    return resnet_block(p.block_2, h)


def apply_vae_decoder(model: AutoencoderKL, z: torch.Tensor,
                      cfg: VAEConfig,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Latents ``[B, embed_dim, h, w]`` → ``[B, out_channels, H, W]`` in
    ``dtype``."""
    del cfg
    h = conv2d(z.to(dtype), model.post_quant_conv, padding=0)
    d = model.decoder
    h = _mid(d.mid, conv2d(h, d.conv_in))
    for level in d.up:
        for blk in level.block:
            h = resnet_block(blk, h)
        if hasattr(level, "upsample"):
            h = conv2d(upsample2x(h), level.upsample)
    h = swish(group_norm(h, d.norm_out))
    return conv2d(h, d.conv_out)


def apply_vae_encoder(model: AutoencoderKL, x: torch.Tensor, cfg: VAEConfig):
    """``[B, in_channels, H, W]`` → (mean, logvar), each ``[B, embed_dim,
    h, w]``, in ``x``'s dtype."""
    del cfg
    e = model.encoder
    h = conv2d(x, e.conv_in)
    for level in e.down:
        for blk in level.block:
            h = resnet_block(blk, h)
        if hasattr(level, "downsample"):
            h = conv2d(F.pad(h, (0, 1, 0, 1)), level.downsample, stride=2,
                       padding=0)
    h = _mid(e.mid, h)
    h = conv2d(swish(group_norm(h, e.norm_out)), e.conv_out)
    moments = conv2d(h, model.quant_conv, padding=0)
    return torch.chunk(moments, 2, dim=1)


# ----------------------------------------------------------------------- #
# Init (random weights from an explicit generator)
# ----------------------------------------------------------------------- #


def init_conv2d(out: dict, generator: torch.Generator, name: str, cin: int,
                cout: int, k: int) -> None:
    """The reference's conv init into ``out`` under ``name``: weights
    N(0, 1/(k·k·cin)) in :class:`Conv2d`'s layout, zero bias."""
    out[f"{name}.w"] = (torch.randn((cout, cin, k, k), generator=generator)
                        * (k * k * cin) ** -0.5)
    out[f"{name}.b"] = torch.zeros(cout)


def init_norm(out: dict, name: str, c: int) -> None:
    out[f"{name}.scale"] = torch.ones(c)
    out[f"{name}.bias"] = torch.zeros(c)


def _init_res(out, gen, name, cin, cout):
    init_norm(out, f"{name}.norm1", cin)
    init_conv2d(out, gen, f"{name}.conv1", cin, cout, 3)
    init_norm(out, f"{name}.norm2", cout)
    init_conv2d(out, gen, f"{name}.conv2", cout, cout, 3)
    if cin != cout:
        init_conv2d(out, gen, f"{name}.nin_shortcut", cin, cout, 1)


def _init_mid(out, gen, name, c):
    _init_res(out, gen, f"{name}.block_1", c, c)
    init_norm(out, f"{name}.attn_1.norm", c)
    for proj in ("q", "k", "v", "proj_out"):
        init_conv2d(out, gen, f"{name}.attn_1.{proj}", c, c, 1)
    _init_res(out, gen, f"{name}.block_2", c, c)


def init_vae_params(generator: torch.Generator, cfg: VAEConfig,
                    prefix: str = "") -> dict:
    """Flat state dict of an :class:`AutoencoderKL` in the reference's
    distributions (convs N(0, 1/fan_in), zero biases, norms 1 and 0); the
    draws differ from ``jax.random``'s."""
    out, g, L = {}, generator, len(cfg.ch_mult)
    init_conv2d(out, g, "encoder.conv_in", cfg.in_channels, cfg.ch, 3)
    ch = cfg.ch
    for i, m in enumerate(cfg.ch_mult):
        for j in range(cfg.num_res_blocks):
            _init_res(out, g, f"encoder.down.{i}.block.{j}", ch, cfg.ch * m)
            ch = cfg.ch * m
        if i != L - 1:
            init_conv2d(out, g, f"encoder.down.{i}.downsample", ch, ch, 3)
    _init_mid(out, g, "encoder.mid", ch)
    init_norm(out, "encoder.norm_out", ch)
    init_conv2d(out, g, "encoder.conv_out", ch, 2 * cfg.z_channels, 3)
    ch = cfg.ch * cfg.ch_mult[-1]
    init_conv2d(out, g, "decoder.conv_in", cfg.z_channels, ch, 3)
    _init_mid(out, g, "decoder.mid", ch)
    for n, i in enumerate(reversed(range(L))):
        cout = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            _init_res(out, g, f"decoder.up.{n}.block.{j}", ch, cout)
            ch = cout
        if i:
            init_conv2d(out, g, f"decoder.up.{n}.upsample", ch, ch, 3)
    init_norm(out, "decoder.norm_out", ch)
    init_conv2d(out, g, "decoder.conv_out", ch, cfg.out_channels, 3)
    init_conv2d(out, g, "quant_conv", 2 * cfg.z_channels, 2 * cfg.embed_dim,
                1)
    init_conv2d(out, g, "post_quant_conv", cfg.embed_dim, cfg.z_channels, 1)
    return {prefix + k: v for k, v in out.items()}
