"""NanoCodec (NVIDIA NeMo: a HiFiGAN autoencoder and grouped FSQ), PyTorch.

Counterpart of ``audiocodecs_tpu/models/nanocodec.py``, weight-compatible
with its param tree through :func:`audiocodecs_tpu_torch.params.
from_jax_params`. The encoder: a causal pre-conv, then per stage a HiFiGAN
res layer (the average of one residual block per kernel size (3, 7, 11),
each a sequence of dilated input/skip conv pairs at dilations (1, 3, 5))
→ half-snake → a strided causal conv doubling the channels, 16 → 1024 over
rates (2, 2, 3, 3, 7, 7) = hop 1764 at 22.05 kHz (12.5 Hz) → half-snake →
post-conv to 16 dims. The quantizer splits those 16 into 4 groups of 4 and
rounds each on its own (8, 8, 8, 8) FSQ lattice (4,096 codes a group, no
parameters). The decoder mirrors it with causal transposed convs and ends
in tanh.

The half-snake (snake on the first half of the channels, leaky ReLU at 0.1
on the rest) is not DAC's unit and runs in plain PyTorch; the convs are
cuDNN calls in exact fp32. No kernel of the package runs here. Inside the
stacks the layout is PyTorch's ``[B, C, T]``.

``decode_dtype`` and ``decode_precision`` (a serving tier's arguments) are
taken and checked but change nothing: the reference's NanoCodec reads no
activation dtype, so its serving tier decodes as its exact one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    conv1d,
    conv_transpose1d,
    init_conv,
)
from audiocodecs_tpu_torch.quant.fsq import (
    fsq_codes_to_indices,
    fsq_implicit_codebook,
    fsq_indices_to_codes,
    fsq_quantize,
)

__all__ = ["NanoCodec", "NanoCodecModelConfig", "init_nanocodec_params"]


@dataclasses.dataclass(frozen=True)
class NanoCodecModelConfig:
    sampling_rate: int = 22050
    base_channels: int = 16
    down_sample_rates: tuple[int, ...] = (2, 2, 3, 3, 7, 7)  # hop 1764
    in_kernel_size: int = 7
    out_kernel_size: int = 7
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[int, ...] = (1, 3, 5)
    levels: tuple[int, ...] = (8, 8, 8, 8)  # per-group lattice (4096)
    num_groups: int = 4
    causal: bool = True

    @property
    def hop_length(self) -> int:
        return math.prod(self.down_sample_rates)

    @property
    def fsq_dim(self) -> int:
        return len(self.levels)

    @property
    def encoded_dim(self) -> int:
        return self.num_groups * self.fsq_dim

    @property
    def final_channels(self) -> int:
        return self.base_channels * (2 ** len(self.down_sample_rates))

    @property
    def vocab_size(self) -> int:
        return math.prod(self.levels)


def _conv(x, conv: Conv1d, causal: bool, stride: int = 1,
          dilation: int = 1):
    """The full (k − 1)·d pad (left, or split when not causal), then a
    valid conv: ⌈T / stride⌉ outputs."""
    span = (conv.w.shape[-1] - 1) * dilation
    left = span if causal else span // 2
    x = F.pad(x, (left, span - left))
    return conv1d(x, conv.w, conv.b, stride=stride, dilation=dilation)


def half_snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """NeMo's HalfSnake on ``[B, C, T]``: snake on the first ``len(alpha)``
    channels, leaky ReLU (0.1) on the rest."""
    half = alpha.shape[0]
    a, b = x[:, :half], x[:, half:]
    al = alpha[:, None]
    a = a + torch.sin(al * a) ** 2 / torch.clamp(al, min=1e-9)
    return torch.cat([a, F.leaky_relu(b, 0.1)], dim=1)


class _Unit(nn.Module):
    """Half-snake → dilated input conv → half-snake → skip conv, plus the
    input."""

    def __init__(self, ch: int, k: int, dilation: int, causal: bool):
        super().__init__()
        self.alpha1 = nn.Parameter(torch.empty(ch // 2))
        self.input_conv = Conv1d(ch, ch, k)
        self.alpha2 = nn.Parameter(torch.empty(ch // 2))
        self.skip_conv = Conv1d(ch, ch, k)
        self.dilation = dilation
        self.causal = causal

    def forward(self, h):
        s = half_snake(h, self.alpha1)
        s = _conv(s, self.input_conv, self.causal, dilation=self.dilation)
        s = _conv(half_snake(s, self.alpha2), self.skip_conv, self.causal)
        return h + s


class _ResBlock(nn.Module):
    def __init__(self, ch, k, dilations, causal):
        super().__init__()
        self.units = nn.ModuleList(_Unit(ch, k, d, causal)
                                   for d in dilations)


class _ResLayer(nn.Module):
    """The average of one residual block per kernel size."""

    def __init__(self, cfg: NanoCodecModelConfig, ch: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            _ResBlock(ch, k, cfg.resblock_dilations, cfg.causal)
            for k in cfg.resblock_kernels)

    def forward(self, x):
        acc = None
        for blk in self.blocks:
            h = x
            for unit in blk.units:
                h = unit(h)
            acc = h if acc is None else acc + h
        return acc / len(self.blocks)


class _EncoderStage(nn.Module):
    def __init__(self, cfg: NanoCodecModelConfig, ch: int, rate: int):
        super().__init__()
        self.res = _ResLayer(cfg, ch)
        self.alpha = nn.Parameter(torch.empty(ch // 2))
        self.down = Conv1d(ch, 2 * ch, 2 * rate)
        self.rate = rate


class _DecoderStage(nn.Module):
    def __init__(self, cfg: NanoCodecModelConfig, ch: int, rate: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(ch // 2))
        self.up = ConvTranspose1d(ch, ch // 2, 2 * rate)
        self.res = _ResLayer(cfg, ch // 2)


class _Encoder(nn.Module):
    """``[B, 1, T]`` → ``[B, encoded_dim, ⌈T / hop⌉]``."""

    def __init__(self, cfg: NanoCodecModelConfig):
        super().__init__()
        self.pre_conv = Conv1d(1, cfg.base_channels, cfg.in_kernel_size)
        stages, ch = [], cfg.base_channels
        for rate in cfg.down_sample_rates:
            stages.append(_EncoderStage(cfg, ch, rate))
            ch *= 2
        self.stages = nn.ModuleList(stages)
        self.post_alpha = nn.Parameter(torch.empty(ch // 2))
        self.post_conv = Conv1d(ch, cfg.encoded_dim, cfg.out_kernel_size)
        self.causal = cfg.causal

    def forward(self, x):
        c = self.causal
        x = _conv(x, self.pre_conv, c)
        for st in self.stages:
            x = half_snake(st.res(x), st.alpha)
            x = _conv(x, st.down, c, stride=st.rate)
        return _conv(half_snake(x, self.post_alpha), self.post_conv, c)


class _Decoder(nn.Module):
    """``[B, encoded_dim, N]`` → ``[B, N · hop]``."""

    def __init__(self, cfg: NanoCodecModelConfig):
        super().__init__()
        ch = cfg.final_channels
        self.pre_conv = Conv1d(cfg.encoded_dim, ch, cfg.in_kernel_size)
        stages = []
        for rate in reversed(cfg.down_sample_rates):
            stages.append(_DecoderStage(cfg, ch, rate))
            ch //= 2
        self.stages = nn.ModuleList(stages)
        self.post_alpha = nn.Parameter(torch.empty(ch // 2))
        self.post_conv = Conv1d(ch, 1, cfg.out_kernel_size)
        self.causal = cfg.causal
        self.rates = tuple(reversed(cfg.down_sample_rates))

    def forward(self, z):
        c = self.causal
        x = _conv(z, self.pre_conv, c)
        for st, rate in zip(self.stages, self.rates):
            x = half_snake(x, st.alpha)
            y = conv_transpose1d(x, st.up.w, st.up.b, stride=rate)
            # trim the transposed conv's overhang (causal: on the right)
            extra = y.shape[-1] - x.shape[-1] * rate
            left = 0 if c else extra // 2
            x = st.res(y[..., left: y.shape[-1] - (extra - left)])
        x = _conv(half_snake(x, self.post_alpha), self.post_conv, c)
        return torch.tanh(x)[:, 0]


class NanoCodec(Codec):
    """NanoCodec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract:
    K ≤ 4 groups, each token an index into its group's 4,096-point FSQ
    lattice (groups past K decode as zeros).

    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_nanocodec_params` from ``generator`` (seed 0 by default).
    Encode mode drops the decoder, decode mode the encoder. ``device=None``
    means the card."""

    DEFAULT_ORIG_SR = 22050

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None):
        return NanoCodecModelConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: Optional[int] = None,
        model_config: Optional[NanoCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        orig_sample_rate = orig_sample_rate or self.DEFAULT_ORIG_SR
        mc = model_config or self.default_model_config(orig_sample_rate)
        num_codebooks = num_codebooks or mc.num_groups
        if num_codebooks > mc.num_groups:
            raise ValueError(
                f"num_codebooks {num_codebooks} > groups {mc.num_groups}")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.vocab_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        if mode != "decode":
            self.encoder = _Encoder(mc)
        if mode != "encode":
            self.decoder = _Decoder(mc)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_nanocodec_params(generator, mc)
        drop = {"encode": ("decoder.",), "decode": ("encoder.",)}.get(
            mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _latents(self, sig):
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _quantize(self, z):
        """Latents ``[B, N, encoded_dim]`` → tokens ``[B, N, K]``."""
        mc = self.model_config
        zg = z.reshape(*z.shape[:2], mc.num_groups, mc.fsq_dim)
        return torch.stack(
            [fsq_codes_to_indices(fsq_quantize(zg[:, :, k], mc.levels),
                                  mc.levels)
             for k in range(self.config.num_codebooks)], dim=-1)

    def _toks_to_codes(self, toks):
        mc = self.model_config
        B, N, K = toks.shape
        parts = [fsq_indices_to_codes(toks[..., k], mc.levels) if k < K
                 else torch.zeros(B, N, mc.fsq_dim, device=toks.device)
                 for k in range(mc.num_groups)]
        return torch.cat(parts, dim=-1)

    def _sig_to_feats(self, sig, length):
        del length
        return self._latents(sig)

    def _sig_to_toks(self, sig, length):
        del length
        return self._quantize(self._latents(sig))

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_codes(self._sig_to_toks(sig, length))

    def _toks_to_qfeats(self, toks, length):
        return self._toks_to_codes(toks)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(self._toks_to_codes(toks), length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))

    def embs(self) -> torch.Tensor:
        """The groups' implicit lattices ``[K, C, fsq_dim]``."""
        cb = torch.from_numpy(fsq_implicit_codebook(self.model_config.levels))
        return cb.to(self.device)[None].repeat(self.config.num_codebooks,
                                               1, 1)


def init_nanocodec_params(generator: torch.Generator,
                          cfg: NanoCodecModelConfig) -> dict:
    """Random weights of :class:`NanoCodec` as a flat state dict, in the
    reference's distributions (convs N(0, 1) · fan_in^-½ with zero biases,
    α = 1); the draws differ from ``jax.random``'s."""
    out = {}

    def res_layer(prefix, ch):
        for bi, k in enumerate(cfg.resblock_kernels):
            for di in range(len(cfg.resblock_dilations)):
                p = f"{prefix}.blocks.{bi}.units.{di}"
                out[f"{p}.alpha1"] = torch.ones(ch // 2)
                init_conv(out, generator, f"{p}.input_conv", ch, ch, k)
                out[f"{p}.alpha2"] = torch.ones(ch // 2)
                init_conv(out, generator, f"{p}.skip_conv", ch, ch, k)

    ch = cfg.base_channels
    init_conv(out, generator, "encoder.pre_conv", 1, ch, cfg.in_kernel_size)
    for si, rate in enumerate(cfg.down_sample_rates):
        p = f"encoder.stages.{si}"
        res_layer(f"{p}.res", ch)
        out[f"{p}.alpha"] = torch.ones(ch // 2)
        init_conv(out, generator, f"{p}.down", ch, 2 * ch, 2 * rate)
        ch *= 2
    out["encoder.post_alpha"] = torch.ones(ch // 2)
    init_conv(out, generator, "encoder.post_conv", ch, cfg.encoded_dim,
              cfg.out_kernel_size)
    init_conv(out, generator, "decoder.pre_conv", cfg.encoded_dim, ch,
              cfg.in_kernel_size)
    for si, rate in enumerate(reversed(cfg.down_sample_rates)):
        p = f"decoder.stages.{si}"
        out[f"{p}.alpha"] = torch.ones(ch // 2)
        init_conv(out, generator, f"{p}.up", ch, ch // 2, 2 * rate,
                  transposed=True)
        res_layer(f"{p}.res", ch // 2)
        ch //= 2
    out["decoder.post_alpha"] = torch.ones(ch // 2)
    init_conv(out, generator, "decoder.post_conv", ch, 1,
              cfg.out_kernel_size)
    return out
