"""AudioDec (the symmetric autoencoder symAD), PyTorch.

Counterpart of ``audiocodecs_tpu/models/audiodec.py``, weight-compatible
with its param tree through :func:`audiocodecs_tpu_torch.params.
from_jax_params`. ``symAD_libritts_24000_hop300``'s structure: a causal
conv encoder (stem k7 1 → 32, then four blocks of three pre-ELU residual
units (k7 at dilations 1, 3, 9, then k1) → ELU → a strided conv k = 2s,
channels 32 → 64 → 128 → 256 → 512 over strides (3, 4, 5, 5), hop 300,
80 Hz), a causal projector conv (512 → 64, k3, no bias), a plain
8 × 1024 × 64 RVQ, and the mirror decoder (stem 64 → 512, ELU → causal
transposed conv k = 2s → residual units, ELU → k7 head). No LSTM and no
weight norm: nothing here runs a kernel of the package; the convs are
cuDNN calls in exact fp32. Inside the stacks the layout is PyTorch's
``[B, C, T]``.

``decode_dtype`` and ``decode_precision`` (a serving tier's arguments) are
taken and checked but change nothing: the reference's AudioDec reads no
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
    elu,
    init_conv,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["AudioDec", "AudioDecModelConfig", "init_audiodec_params"]


@dataclasses.dataclass(frozen=True)
class AudioDecModelConfig:
    sampling_rate: int = 24000
    encode_channels: int = 32
    channel_ratios: tuple[int, ...] = (2, 4, 8, 16)
    strides: tuple[int, ...] = (3, 4, 5, 5)  # hop 300 → 80 Hz
    kernel_size: int = 7
    dilations: tuple[int, ...] = (1, 3, 9)
    code_dim: int = 64
    codebook_size: int = 1024
    num_quantizers: int = 8

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(self.encode_channels * r for r in self.channel_ratios)


def _cconv(x, conv: Conv1d, stride: int = 1, dilation: int = 1):
    """Causal conv: left pad (k − 1)·d, then valid."""
    k = conv.w.shape[-1]
    return conv1d(F.pad(x, ((k - 1) * dilation, 0)), conv.w, conv.b,
                  stride=stride, dilation=dilation)


def _cconvtr(x, conv: ConvTranspose1d, stride: int):
    """Causal transposed conv: the first T·s outputs."""
    y = conv_transpose1d(x, conv.w, conv.b, stride=stride)
    return y[..., : x.shape[-1] * stride]


class _ResUnit(nn.Module):
    """ELU → k7 dilated causal conv → ELU → 1×1, plus the input."""

    def __init__(self, ch: int, k: int, dilation: int):
        super().__init__()
        self.conv1 = Conv1d(ch, ch, k, bias=False)
        self.conv2 = Conv1d(ch, ch, 1, bias=False)
        self.dilation = dilation

    def forward(self, x):
        y = _cconv(elu(x), self.conv1, dilation=self.dilation)
        return x + _cconv(elu(y), self.conv2)


class _Block(nn.Module):
    def __init__(self, cfg: AudioDecModelConfig, ch: int, cin: int,
                 cout: int, stride: int, up: bool):
        super().__init__()
        self.res = nn.ModuleList(_ResUnit(ch, cfg.kernel_size, d)
                                 for d in cfg.dilations)
        if up:
            self.up = ConvTranspose1d(cin, cout, 2 * stride)
        else:
            self.down = Conv1d(cin, cout, 2 * stride)
        self.stride = stride


class _Encoder(nn.Module):
    def __init__(self, cfg: AudioDecModelConfig):
        super().__init__()
        self.stem = Conv1d(1, cfg.encode_channels, cfg.kernel_size)
        blocks, ch = [], cfg.encode_channels
        for out, stride in zip(cfg.widths, cfg.strides):
            blocks.append(_Block(cfg, ch, ch, out, stride, up=False))
            ch = out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = _cconv(x, self.stem)
        for b in self.blocks:
            for unit in b.res:
                x = unit(x)
            x = _cconv(elu(x), b.down, stride=b.stride)
        return x


class _Decoder(nn.Module):
    def __init__(self, cfg: AudioDecModelConfig):
        super().__init__()
        widths = cfg.widths
        self.stem = Conv1d(cfg.code_dim, widths[-1], cfg.kernel_size)
        outs = (*widths[::-1][1:], cfg.encode_channels)
        blocks, ch = [], widths[-1]
        for out, stride in zip(outs, reversed(cfg.strides)):
            blocks.append(_Block(cfg, out, ch, out, stride, up=True))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv1d(cfg.encode_channels, 1, cfg.kernel_size)

    def forward(self, q):
        x = _cconv(q, self.stem)
        for b in self.blocks:
            x = _cconvtr(elu(x), b.up, b.stride)
            for unit in b.res:
                x = unit(x)
        return _cconv(elu(x), self.head)


class AudioDec(Codec):
    """AudioDec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract.

    The RVQ keeps its first ``num_codebooks`` stages (the reference
    truncates its quantizer in place). ``state_dict`` is loaded strictly;
    without it the weights are drawn by :func:`init_audiodec_params` from
    ``generator`` (seed 0 by default). Encode mode drops the decoder,
    decode mode the encoder and the projector. ``device=None`` means the
    card."""

    DEFAULT_ORIG_SR = 24000

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None):
        return AudioDecModelConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        model_config: Optional[AudioDecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        orig_sample_rate = orig_sample_rate or self.DEFAULT_ORIG_SR
        mc = model_config or self.default_model_config(orig_sample_rate)
        if num_codebooks > mc.num_quantizers:
            raise ValueError(f"num_codebooks {num_codebooks} > "
                             f"{mc.num_quantizers}")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        if mode != "decode":
            self.encoder = _Encoder(mc)
            self.projector = Conv1d(mc.widths[-1], mc.code_dim, 3,
                                    bias=False)
        if mode != "encode":
            self.decoder = _Decoder(mc)
        self.codebooks = nn.Parameter(torch.empty(
            num_codebooks, mc.codebook_size, mc.code_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_audiodec_params(generator, mc)
        state_dict = dict(state_dict)
        state_dict["codebooks"] = state_dict["codebooks"][:num_codebooks]
        drop = {"encode": ("decoder.",),
                "decode": ("encoder.", "projector.")}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _project(self, sig):
        z = _cconv(self.encoder(sig[:, None, :]), self.projector)
        return z.transpose(1, 2)  # [B, N, code_dim]

    def _decode(self, q):
        return self.decoder(q.transpose(1, 2))[:, 0]

    def _sig_to_feats(self, sig, length):
        del length
        return self._project(sig)

    def _sig_to_toks(self, sig, length):
        return rvq_encode(self._project(sig), self.codebooks)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        return self._decode(rvq_decode(toks, self.codebooks))

    def _feats_to_sig(self, feats, length):
        return self._decode(feats)

    def embs(self) -> torch.Tensor:
        """The RVQ codebooks ``[K, C, code_dim]``."""
        return self.codebooks.detach()


def init_audiodec_params(generator: torch.Generator,
                         cfg: AudioDecModelConfig) -> dict:
    """Random weights of :class:`AudioDec` (every quantizer stage) as a flat
    state dict, in the reference's distributions; the draws differ from
    ``jax.random``'s."""
    out = {}
    k, widths = cfg.kernel_size, cfg.widths

    def units(prefix, ch):
        for j in range(len(cfg.dilations)):
            init_conv(out, generator, f"{prefix}.res.{j}.conv1", ch, ch, k,
                      bias=False)
            init_conv(out, generator, f"{prefix}.res.{j}.conv2", ch, ch, 1,
                      bias=False)

    init_conv(out, generator, "encoder.stem", 1, cfg.encode_channels, k)
    ch = cfg.encode_channels
    for i, (w, s) in enumerate(zip(widths, cfg.strides)):
        units(f"encoder.blocks.{i}", ch)
        init_conv(out, generator, f"encoder.blocks.{i}.down", ch, w, 2 * s)
        ch = w
    init_conv(out, generator, "projector", widths[-1], cfg.code_dim, 3,
              bias=False)
    out["codebooks"] = torch.randn(
        (cfg.num_quantizers, cfg.codebook_size, cfg.code_dim),
        generator=generator)
    init_conv(out, generator, "decoder.stem", cfg.code_dim, widths[-1], k)
    outs = (*widths[::-1][1:], cfg.encode_channels)
    for i, (o, s) in enumerate(zip(outs, reversed(cfg.strides))):
        init_conv(out, generator, f"decoder.blocks.{i}.up", ch, o, 2 * s,
                  transposed=True)
        units(f"decoder.blocks.{i}", o)
        ch = o
    init_conv(out, generator, "decoder.head", cfg.encode_channels, 1, k)
    return out
