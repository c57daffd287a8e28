"""HILCodec (variance-constrained lightweight streaming codec), PyTorch.

Counterpart of ``audiocodecs_tpu/models/hilcodec.py``, weight-compatible
with its param tree through :func:`audiocodecs_tpu_torch.params.
from_jax_params`. The reference's reconstruction of the paper
(arXiv:2405.04752): fully causal conv towers, strides (2, 4, 5, 8) = hop
320 at 24 kHz (75 Hz), 8 × 1024 × 128 RVQ; residual units of a depthwise
k7 conv and a pointwise 1×1, each residual sum scaled by 1/√2 (the
variance constraint); waveform skips: each encoder block adds the input
waveform mean-pooled to its rate through a 1×1 conv, and each decoder
block emits a one-channel waveform head, repeated up to the output rate
and summed into it. Every conv is a cuDNN call in exact fp32; no kernel of
the package runs here. Inside the stacks the layout is PyTorch's
``[B, C, T]``.

Streaming (:meth:`HILCodec.encode_chunk`): every encoder conv is causal
with a constant left context, and the skips' pooling windows do not
overlap, so carrying each conv's left context from chunk to chunk gives
the batch encoder's tokens for whole-frame chunks.

``decode_dtype`` and ``decode_precision`` (a serving tier's arguments) set
the decoder's :class:`..nn.layers.DecodeForm` as the reference's switches
do, where its decoder runs inside ``conv_role("decoder")``: fp32
activations at ``decode_precision="default"`` (its
``ACX_DEC_CONV_PRECISION=default``) run every decoder conv and transposed
conv (the waveform heads' 1×1 convs and the depthwise ones included) on
bf16-rounded operands with fp32 sums, one bf16 pass. The reference's
HILCodec reads no activation dtype, so bf16 activations (the EnCodec-style
tier, which sets no decoder precision) decode exactly, as at the default.
The reference's bf16 activations together with
``ACX_DEC_CONV_PRECISION=default`` have no name among the port's arguments,
and no preset reaches them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig, _serving
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    conv1d,
    elu,
    init_conv,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["HILCodec", "HILCodecModelConfig", "init_hilcodec_params"]

_INV_SQRT2 = 0.7071067811865476


@dataclasses.dataclass(frozen=True)
class HILCodecModelConfig:
    sampling_rate: int = 24000
    channels: int = 32
    max_channels: int = 512
    strides: tuple[int, ...] = (2, 4, 5, 8)  # hop 320 → 75 Hz
    kernel_size: int = 7
    res_kernel_size: int = 7
    res_units_per_block: int = 2
    res_dilations: tuple[int, ...] = (1, 3)
    emb_dim: int = 128
    codebook_size: int = 1024
    num_quantizers: int = 8
    waveform_skips: bool = True
    depthwise: bool = True
    var_constrained: bool = True

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)

    @property
    def widths(self) -> tuple[int, ...]:
        """Channel width at the input of each block (after the stem)."""
        out, c = [], self.channels
        for _ in self.strides:
            out.append(c)
            c = min(2 * c, self.max_channels)
        return tuple(out)

    @property
    def dilations(self) -> tuple[int, ...]:
        return tuple(self.res_dilations)[: self.res_units_per_block]

    @property
    def top_width(self) -> int:
        return min(2 * self.widths[-1], self.max_channels)


def _cconv(x, conv: Conv1d, stride: int = 1, dilation: int = 1,
           groups: int = 1, form: DecodeForm = DecodeForm()):
    """Causal conv: left pad (k − 1)·d − (s − 1), then valid, in ``form``."""
    pad = (conv.w.shape[-1] - 1) * dilation - (stride - 1)
    if pad > 0:
        x = F.pad(x, (pad, 0))
    return form.conv1d(x, conv, stride=stride, dilation=dilation,
                       groups=groups)


def _cconvtr(x, conv: ConvTranspose1d, stride: int, form: DecodeForm):
    """Causal transposed conv: the first T·s outputs, in ``form``."""
    y = form.conv_transpose1d(x, conv, stride=stride)
    return y[..., : x.shape[-1] * stride]


def _pool_wave(sig, rate: int):
    """Mean of non-overlapping windows of ``rate`` samples: ``[B, T]`` →
    ``[B, 1, T // rate]`` (causal: window i covers [i·rate, (i+1)·rate))."""
    B, n = sig.shape[0], sig.shape[1] // rate
    return sig[:, : n * rate].reshape(B, n, rate).mean(dim=-1)[:, None]


class _ResUnit(nn.Module):
    def __init__(self, cfg: HILCodecModelConfig, ch: int, dilation: int):
        super().__init__()
        self.groups = ch if cfg.depthwise else 1
        self.dw = Conv1d(ch // self.groups, ch, cfg.res_kernel_size)
        self.pw = Conv1d(ch, ch, 1)
        self.dilation = dilation
        self.scaled = cfg.var_constrained

    def close(self, x, h, form: DecodeForm = DecodeForm()):
        """The unit's output from its input ``x`` and its depthwise conv's
        output ``h``: the pointwise half, the residual sum, its scale."""
        y = x + form.conv1d(elu(h), self.pw)
        return y * _INV_SQRT2 if self.scaled else y

    def forward(self, x, form: DecodeForm = DecodeForm()):
        h = _cconv(elu(x), self.dw, dilation=self.dilation,
                   groups=self.groups, form=form)
        return self.close(x, h, form)


class _EncoderBlock(nn.Module):
    def __init__(self, cfg: HILCodecModelConfig, ch: int, stride: int):
        super().__init__()
        self.res = nn.ModuleList(_ResUnit(cfg, ch, d) for d in cfg.dilations)
        self.down = Conv1d(ch, min(2 * ch, cfg.max_channels), 2 * stride)
        if cfg.waveform_skips:
            self.skip = Conv1d(1, ch, 1)
        self.stride = stride


class _DecoderBlock(nn.Module):
    def __init__(self, cfg: HILCodecModelConfig, cin: int, cout: int,
                 stride: int):
        super().__init__()
        self.up = ConvTranspose1d(cin, cout, 2 * stride)
        self.res = nn.ModuleList(_ResUnit(cfg, cout, d)
                                 for d in cfg.dilations)
        if cfg.waveform_skips:
            self.skip = Conv1d(cout, 1, 1)
        self.stride = stride


class _Encoder(nn.Module):
    """``[B, T]`` → ``[B, emb_dim, N]``."""

    def __init__(self, cfg: HILCodecModelConfig):
        super().__init__()
        self.stem = Conv1d(1, cfg.channels, cfg.kernel_size)
        self.blocks = nn.ModuleList(
            _EncoderBlock(cfg, ch, s) for ch, s in zip(cfg.widths,
                                                        cfg.strides))
        self.head = Conv1d(cfg.top_width, cfg.emb_dim, 3)
        self.skips = cfg.waveform_skips

    def forward(self, sig):
        x = _cconv(sig[:, None, :], self.stem)
        rate = 1
        for b in self.blocks:
            if self.skips:
                w = _pool_wave(sig, rate)[..., : x.shape[-1]]
                x = x + conv1d(w, b.skip.w, b.skip.b)
            for unit in b.res:
                x = unit(x)
            x = _cconv(elu(x), b.down, stride=b.stride)
            rate *= b.stride
        return _cconv(elu(x), self.head)


class _Decoder(nn.Module):
    """``[B, emb_dim, N]`` → ``[B, N·hop]`` (the waveform heads summed in),
    every conv in ``form``."""

    def __init__(self, cfg: HILCodecModelConfig,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        self.form = form
        self.stem = Conv1d(cfg.emb_dim, cfg.top_width, 3)
        blocks, ch = [], cfg.top_width
        for out, s in zip(reversed(cfg.widths), reversed(cfg.strides)):
            blocks.append(_DecoderBlock(cfg, ch, out, s))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv1d(ch, 1, cfg.kernel_size)
        self.skips = cfg.waveform_skips
        self.hop = cfg.hop_length

    def forward(self, q):
        f = self.form
        x = _cconv(q, self.stem, form=f)
        rate, out = self.hop, None
        for b in self.blocks:
            x = _cconvtr(elu(x), b.up, b.stride, f)
            rate //= b.stride
            for unit in b.res:
                x = unit(x, f)
            if self.skips:
                w = torch.repeat_interleave(f.conv1d(x, b.skip), rate,
                                            dim=-1)
                out = w if out is None else out[..., : w.shape[-1]] + w
        y = _cconv(elu(x), self.head, form=f)
        if out is not None:
            y = y + out[..., : y.shape[-1]]
        return y[:, 0]


class HILCodec(Codec):
    """HILCodec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract and
    a streaming encoder (:meth:`init_streaming_state`, :meth:`encode_chunk`).

    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_hilcodec_params` from ``generator`` (seed 0 by default).
    The RVQ searches the first ``num_codebooks`` of its stages. Encode mode
    drops the decoder, decode mode the encoder. ``device=None`` means the
    card."""

    DEFAULT_ORIG_SR = 24000

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None):
        return HILCodecModelConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        model_config: Optional[HILCodecModelConfig] = None,
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
            raise ValueError(
                f"num_codebooks {num_codebooks} > {mc.num_quantizers}")
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
        if mode != "encode":
            self.decoder = _Decoder(mc, form.ignoring_dtype())
        self.codebooks = nn.Parameter(torch.empty(
            mc.num_quantizers, mc.codebook_size, mc.emb_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_hilcodec_params(generator, mc)
        drop = {"encode": ("decoder.",), "decode": ("encoder.",)}.get(
            mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    @property
    def frame_size(self) -> int:
        return self.model_config.hop_length

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode(self, sig):
        return self.encoder(sig).transpose(1, 2)  # [B, N, emb_dim]

    def _sig_to_feats(self, sig, length):
        del length
        return self._encode(sig)

    def _sig_to_toks(self, sig, length):
        return rvq_encode(self._encode(sig), self.codebooks,
                          self.config.num_codebooks)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(rvq_decode(toks, self.codebooks), length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))

    def embs(self) -> torch.Tensor:
        """``[K, C, emb_dim]``: the searched stages' codebooks."""
        return self.codebooks.detach()[: self.config.num_codebooks]

    # Chunked streaming ----------------------------------------------------- #

    def init_streaming_state(self, batch: int) -> dict:
        """Zero left context of every encoder conv, ``[B, C, context]`` on
        the codec's device: the stem (k − 1), each depthwise conv
        ((k − 1)·d), each strided conv (k − s) and the head (k − 1)."""
        enc, mc = self.encoder, self.model_config

        def zeros(ch, n):
            return torch.zeros(batch, ch, n, device=self.device)

        state = {"stem": zeros(1, enc.stem.w.shape[-1] - 1)}
        for bi, b in enumerate(enc.blocks):
            ch = mc.widths[bi]
            for ri, unit in enumerate(b.res):
                state[f"b{bi}r{ri}"] = zeros(
                    ch, (unit.dw.w.shape[-1] - 1) * unit.dilation)
            state[f"b{bi}d"] = zeros(ch, b.down.w.shape[-1] - b.stride)
        state["head"] = zeros(mc.top_width, enc.head.w.shape[-1] - 1)
        return state

    @_serving
    def encode_chunk(self, chunk, state: dict):
        """One chunk ``[B, n·hop]`` at the model's rate → (tokens
        ``[B, n, K]``, new state). Chunks must be whole frames."""
        sig = self._tensor(chunk, torch.float32)
        enc, new = self.encoder, {}

        def carried(x, conv, key, stride=1, dilation=1, groups=1):
            xin = torch.cat([state[key], x], dim=-1)
            keep = state[key].shape[-1]
            new[key] = xin[..., xin.shape[-1] - keep:]
            return conv1d(xin, conv.w, conv.b, stride=stride,
                          dilation=dilation, groups=groups)

        x = carried(sig[:, None, :], enc.stem, "stem")
        rate = 1
        for bi, b in enumerate(enc.blocks):
            if enc.skips:
                w = _pool_wave(sig, rate)[..., : x.shape[-1]]
                x = x + conv1d(w, b.skip.w, b.skip.b)
            for ri, unit in enumerate(b.res):
                h = carried(elu(x), unit.dw, f"b{bi}r{ri}",
                            dilation=unit.dilation, groups=unit.groups)
                x = unit.close(x, h)
            x = carried(elu(x), b.down, f"b{bi}d", stride=b.stride)
            rate *= b.stride
        z = carried(elu(x), enc.head, "head").transpose(1, 2)
        return rvq_encode(z, self.codebooks, self.config.num_codebooks), new


def init_hilcodec_params(generator: torch.Generator,
                         cfg: HILCodecModelConfig) -> dict:
    """Random weights of :class:`HILCodec` as a flat state dict, in the
    reference's distributions (convs N(0, 1) · fan_in^-½ with zero biases,
    codebooks N(0, 1/emb_dim)); the draws differ from ``jax.random``'s."""
    out = {}

    def units(prefix, ch):
        groups = ch if cfg.depthwise else 1
        for j in range(len(cfg.dilations)):
            init_conv(out, generator, f"{prefix}.res.{j}.dw", ch, ch,
                      cfg.res_kernel_size, groups=groups)
            init_conv(out, generator, f"{prefix}.res.{j}.pw", ch, ch, 1)

    init_conv(out, generator, "encoder.stem", 1, cfg.channels,
              cfg.kernel_size)
    for i, (ch, s) in enumerate(zip(cfg.widths, cfg.strides)):
        p = f"encoder.blocks.{i}"
        units(p, ch)
        init_conv(out, generator, f"{p}.down", ch,
                  min(2 * ch, cfg.max_channels), 2 * s)
        if cfg.waveform_skips:
            init_conv(out, generator, f"{p}.skip", 1, ch, 1)
    init_conv(out, generator, "encoder.head", cfg.top_width, cfg.emb_dim, 3)
    init_conv(out, generator, "decoder.stem", cfg.emb_dim, cfg.top_width, 3)
    ch = cfg.top_width
    for i, (o, s) in enumerate(zip(reversed(cfg.widths),
                                   reversed(cfg.strides))):
        p = f"decoder.blocks.{i}"
        init_conv(out, generator, f"{p}.up", ch, o, 2 * s, transposed=True)
        units(p, o)
        if cfg.waveform_skips:
            init_conv(out, generator, f"{p}.skip", o, 1, 1)
        ch = o
    init_conv(out, generator, "decoder.head", ch, 1, cfg.kernel_size)
    out["codebooks"] = (torch.randn(
        (cfg.num_quantizers, cfg.codebook_size, cfg.emb_dim),
        generator=generator) * cfg.emb_dim ** -0.5)
    return out
