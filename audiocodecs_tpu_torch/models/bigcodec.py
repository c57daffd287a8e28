"""BigCodec, PyTorch.

Counterpart of ``audiocodecs_tpu/models/bigcodec.py`` (Xin et al., 2024;
``Alethia/BigCodec``), weight-compatible with its param tree through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. A DAC-lineage codec at
16 kHz:

* encoder (:class:`CodecEncoder`, shared with XCodec 2.0): conv7 stem → per
  stage [3 residual units (dilations 1, 3, 9, snake) → snake → strided conv
  k = 2s] with channel doubling (48 → 1536 over ratios (2, 2, 2, 5, 5), hop
  200, 80 Hz) → a 2-layer residual LSTM bottleneck at H = 1536 → snake →
  conv3 to ``hidden_size`` (1024);
* one factorized cosine VQ: ``in_proj`` 1024 → 8, unit-normed query and
  codebook, a ``[B·N, 8] @ [8, 8192]`` search in fp32, first maximal index;
  ``out_proj`` 8 → 1024 back;
* decoder: conv7 stem → the residual LSTM (H = 1536) → per stage [snake →
  transposed conv k = 2s, trimmed by ⌈s/2⌉ on the left and ⌈s/2⌉ − s mod 2
  on the right, so N frames become N·s samples → 3 residual units] →
  snake → conv7 → tanh.

The residual units are DAC's (:class:`..models.dac.ResidualUnit`): the
decoder's units of at most 256 channels (C = 192, 96 and 48 at the
published width: 9 a decode) launch the fused unit kernel on the card, the
encoder's and the wider decoder's run unfused. The four LSTM layers (2 in
the encoder, 2 in the decoder) each launch the recurrence kernel's wide
instance, once for every 8 batch rows. Inside the stacks the layout is
PyTorch's ``[B, C, T]``.

The decoder computes in a :class:`..models.dac.DecodeForm` (``BigCodec(...,
decode_dtype, decode_precision, snake_poly)``), the reference's serving
tier (``_decode_z_inner`` under its environment switches): with bf16
activations the stem and every conv run in bf16, the six wide units
unfused in bf16, the nine narrow ones on the kernel's bf16 form; the
decoder's residual LSTM stays an fp32 island (fp32 weights, on the
recurrence kernel) whose output is cast back. The encoder and the
quantizer run exact fp32 in every form. The reference's wide-LSTM role
gate selects nothing here: every LSTM runs on the kernel in exact fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import (
    Codec,
    CodecConfig,
    prune_params_for_mode,
)
from audiocodecs_tpu_torch.models.dac import (
    ResidualUnit,
    _conv,
    fused_resunit,
    snake,
)
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    exact_fp32,
    init_conv,
    unit_norm,
)
from audiocodecs_tpu_torch.nn.lstm import LSTM, init_lstm_params
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear

__all__ = ["BigCodec", "BigCodecModelConfig", "CodecEncoder",
           "init_bigcodec_params", "init_codec_encoder_params"]


@dataclasses.dataclass(frozen=True)
class BigCodecModelConfig:
    sampling_rate: int = 16000
    ngf: int = 48
    up_ratios: tuple[int, ...] = (2, 2, 2, 5, 5)  # hop 200 → 80 Hz
    dilations: tuple[int, ...] = (1, 3, 9)
    hidden_size: int = 1024  # encoder output / decoder input
    codebook_size: int = 8192
    codebook_dim: int = 8
    rnn_layers: int = 2

    @property
    def hop_length(self) -> int:
        return math.prod(self.up_ratios)

    @property
    def enc_width(self) -> int:
        return self.ngf * (2 ** len(self.up_ratios))


def _res_units(ch: int, role: str, dilations,
               form: DecodeForm = DecodeForm()) -> nn.ModuleList:
    """DAC's residual units, fused where DAC's gate fuses them."""
    return nn.ModuleList(ResidualUnit(ch, d, fused_resunit(role, ch), form)
                         for d in dilations)


class _EncoderBlock(nn.Module):
    def __init__(self, ch: int, stride: int, dilations):
        super().__init__()
        self.res = _res_units(ch, "encoder", dilations)
        self.alpha_down = nn.Parameter(torch.empty(ch))
        self.conv_down = Conv1d(ch, 2 * ch, 2 * stride)
        self.stride = stride

    def forward(self, x):
        for unit in self.res:
            x = unit(x)
        x = snake(x, self.alpha_down)
        return _conv(x, self.conv_down, stride=self.stride,
                     pad=math.ceil(self.stride / 2))


def _residual_lstm(h: torch.Tensor, rnn: LSTM) -> torch.Tensor:
    """``h + LSTM(h)`` over ``[B, C, T]`` (the bottleneck of both stacks),
    in fp32 whatever ``h``'s dtype, cast back to it."""
    x = h.transpose(1, 2).float()
    y, _ = rnn(x)
    return (x + y).to(h.dtype).transpose(1, 2)


class CodecEncoder(nn.Module):
    """The BigCodec-lineage encoder (the reference's
    ``apply_codec_encoder``): ``[B, 1, T]`` → ``[B, hidden, T / hop]``.
    XCodec 2.0's encoder is the same module at hop 320."""

    def __init__(self, cfg: BigCodecModelConfig):
        super().__init__()
        d = cfg.ngf
        self.stem = Conv1d(1, d, 7)
        blocks = []
        for stride in cfg.up_ratios:
            blocks.append(_EncoderBlock(d, stride, cfg.dilations))
            d *= 2
        self.blocks = nn.ModuleList(blocks)
        self.rnn = LSTM(cfg.rnn_layers, d, d)
        self.alpha_out = nn.Parameter(torch.empty(d))
        self.conv_out = Conv1d(d, cfg.hidden_size, 3)

    def forward(self, x):
        h = _conv(x, self.stem, pad=3)
        for block in self.blocks:
            h = block(h)
        h = _residual_lstm(h, self.rnn)
        return _conv(snake(h, self.alpha_out), self.conv_out, pad=1)


class _DecoderBlock(nn.Module):
    def __init__(self, cin: int, stride: int, dilations,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        self.alpha_up = nn.Parameter(torch.empty(cin))
        self.convtr = ConvTranspose1d(cin, cin // 2, 2 * stride)
        self.res = _res_units(cin // 2, "decoder", dilations, form)
        self.stride = stride
        self.form = form

    def forward(self, x):
        f, s = self.form, self.stride
        x = snake(x, f.param(self, "alpha_up"), f.snake_poly)
        y = f.conv_transpose1d(x, self.convtr, stride=s)
        left = math.ceil(s / 2)
        x = y[..., left: y.shape[-1] - (left - s % 2)]
        for unit in self.res:
            x = unit(x)
        return x


class Decoder(nn.Module):
    """``[B, hidden, N]`` → ``[B, 1, N · hop]`` float32, computed in
    ``form``."""

    def __init__(self, cfg: BigCodecModelConfig,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        d = cfg.enc_width
        self.stem = Conv1d(cfg.hidden_size, d, 7)
        self.rnn = LSTM(cfg.rnn_layers, d, d)
        blocks = []
        for stride in reversed(cfg.up_ratios):
            blocks.append(_DecoderBlock(d, stride, cfg.dilations, form))
            d //= 2
        self.blocks = nn.ModuleList(blocks)
        self.alpha_out = nn.Parameter(torch.empty(d))
        self.conv_out = Conv1d(d, 1, 7)
        self.form = form

    def forward(self, z):
        f = self.form
        h = _residual_lstm(f.conv1d(z.to(f.dtype), self.stem, pad=3),
                           self.rnn)
        for block in self.blocks:
            h = block(h)
        h = snake(h, f.param(self, "alpha_out"), f.snake_poly)
        return torch.tanh(f.conv1d(h, self.conv_out, pad=3)).float()


class Quantizer(nn.Module):
    """The single factorized, L2-normalized VQ."""

    def __init__(self, cfg: BigCodecModelConfig):
        super().__init__()
        self.in_proj = Linear(cfg.hidden_size, cfg.codebook_dim, bias=True)
        self.codebook = nn.Parameter(
            torch.empty(cfg.codebook_size, cfg.codebook_dim))
        self.out_proj = Linear(cfg.codebook_dim, cfg.hidden_size, bias=True)

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, N, hidden]`` → indices ``[B, N]``: cosine search in fp32,
        the first maximal index on ties."""
        e = unit_norm(_linear(z, self.in_proj))
        with exact_fp32():
            scores = torch.matmul(e, unit_norm(self.codebook).T)
        return torch.argmax(scores, dim=-1)

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return _linear(self.codebook[idx], self.out_proj)


class BigCodec(Codec):
    """BigCodec with the standardized ``[B,T]`` ↔ ``[B,N,1]`` contract.

    Single codebook (``num_codebooks`` must be 1). ``latent`` (the default,
    as in the reference) makes ``sig_to_feats`` return the 8-d ``in_proj``
    output and ``embs()`` the raw codebook; otherwise the 1024-d encoder
    output and the ``out_proj`` image. ``state_dict`` (e.g. from
    :func:`audiocodecs_tpu_torch.params.from_jax_params`) is loaded
    strictly; without it the weights are drawn by
    :func:`init_bigcodec_params` from ``generator`` (seed 0 by default).
    ``device=None`` means the card. ``decode_dtype``, ``decode_precision``
    and ``snake_poly`` are the decoder's
    :class:`..models.dac.DecodeForm` (a serving tier; exact fp32 by
    default).
    """

    DEFAULT_ORIG_SR = 16000
    # the reference keeps snake's α as [1, 1, C]; the bridge restores it
    JAX_ALPHA_SHAPE = (1, 1, -1)

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return BigCodecModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        latent: bool = True,
        model_config: Optional[BigCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        snake_poly: bool = False,
    ):
        form = DecodeForm(decode_dtype, decode_precision, snake_poly)
        if num_codebooks != 1:
            raise ValueError("BigCodec is single-codebook (K=1)")
        mc = model_config or BigCodecModelConfig(
            sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.latent = latent
        self.decode_form = form
        if mode != "decode":
            self.encoder = CodecEncoder(mc)
        self.quantizer = Quantizer(mc)
        if mode != "encode":
            self.decoder = Decoder(mc, form)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_bigcodec_params(generator, mc)
        self.load_state_dict(prune_params_for_mode(state_dict, mode),
                             strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode_z(self, sig):
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_toks(self, sig, length):
        del length  # masking is caller-side padding
        return self.quantizer.encode(self._encode_z(sig))[..., None]

    def _sig_to_feats(self, sig, length):
        del length
        z = self._encode_z(sig)
        return _linear(z, self.quantizer.in_proj) if self.latent else z

    def _sig_to_qfeats(self, sig, length):
        return self.quantizer.decode(self._sig_to_toks(sig, length)[..., 0])

    def _toks_to_qfeats(self, toks, length):
        return self.quantizer.decode(toks[..., 0])

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(self.quantizer.decode(toks[..., 0]), length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))[:, 0]

    def embs(self) -> torch.Tensor:
        """``[1, C, 8]`` (latent) or ``[1, C, hidden]`` codebook."""
        q = self.quantizer
        with torch.inference_mode():
            if self.latent:
                return q.codebook.detach()[None]
            return _linear(q.codebook, q.out_proj)[None]


def init_codec_encoder_params(generator: torch.Generator,
                              cfg: BigCodecModelConfig,
                              prefix: str = "encoder") -> dict:
    """Random weights of :class:`CodecEncoder` as a flat state dict under
    ``prefix``, in the reference's distributions (conv weights N(0, 1) ·
    (K·Cin)^-½ with zero biases, α = 1, LSTMs uniform in ±1/√H) but for each
    residual unit's closing 1×1 conv, drawn at a tenth of that scale: at
    unit gain the residual adds grow the activations about twofold a unit,
    and at the published width tanh saturates 91 % of the decoded samples,
    which would leave little for a decode to be checked on. The draws differ
    from the reference's."""
    out = {}
    d = cfg.ngf
    init_conv(out, generator, f"{prefix}.stem", 1, d, 7)
    for i, stride in enumerate(cfg.up_ratios):
        _units_init(out, generator, f"{prefix}.blocks.{i}", d,
                    len(cfg.dilations))
        out[f"{prefix}.blocks.{i}.alpha_down"] = torch.ones(d)
        init_conv(out, generator, f"{prefix}.blocks.{i}.conv_down", d,
                  2 * d, 2 * stride)
        d *= 2
    _lstm_init(out, generator, f"{prefix}.rnn", cfg.rnn_layers, d)
    out[f"{prefix}.alpha_out"] = torch.ones(d)
    init_conv(out, generator, f"{prefix}.conv_out", d, cfg.hidden_size, 3)
    return out


def init_bigcodec_params(generator: torch.Generator,
                         cfg: BigCodecModelConfig) -> dict:
    """Random weights of :class:`BigCodec` as a flat state dict, in
    :func:`init_codec_encoder_params`'s distributions (codebook N(0, 1),
    projections N(0, 1) · fan_in^-½ with zero biases); the draws differ from
    the reference's."""
    H, D, W = cfg.hidden_size, cfg.codebook_dim, cfg.enc_width
    out = init_codec_encoder_params(generator, cfg)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=generator) * scale

    out["quantizer.in_proj.w"] = randn(H, D, scale=H ** -0.5)
    out["quantizer.in_proj.b"] = torch.zeros(D)
    out["quantizer.codebook"] = randn(cfg.codebook_size, D)
    out["quantizer.out_proj.w"] = randn(D, H, scale=D ** -0.5)
    out["quantizer.out_proj.b"] = torch.zeros(H)

    init_conv(out, generator, "decoder.stem", H, W, 7)
    _lstm_init(out, generator, "decoder.rnn", cfg.rnn_layers, W)
    d = W
    for i, stride in enumerate(reversed(cfg.up_ratios)):
        p = f"decoder.blocks.{i}"
        out[f"{p}.alpha_up"] = torch.ones(d)
        init_conv(out, generator, f"{p}.convtr", d, d // 2, 2 * stride,
                  transposed=True)
        _units_init(out, generator, p, d // 2, len(cfg.dilations))
        d //= 2
    out["decoder.alpha_out"] = torch.ones(d)
    init_conv(out, generator, "decoder.conv_out", d, 1, 7)
    return out


def _units_init(out, generator, prefix, ch, n):
    for ri in range(n):
        p = f"{prefix}.res.{ri}"
        out[f"{p}.alpha1"] = torch.ones(ch)
        init_conv(out, generator, f"{p}.conv1", ch, ch, 7)
        out[f"{p}.alpha2"] = torch.ones(ch)
        init_conv(out, generator, f"{p}.conv2", ch, ch, 1, gain=0.1)


def _lstm_init(out, generator, prefix, layers, width):
    for li, p in enumerate(init_lstm_params(generator, layers, width, width)):
        for k, v in p.items():
            out[f"{prefix}.{li}.{k}"] = v
