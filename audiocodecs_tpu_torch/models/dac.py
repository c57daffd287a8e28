"""DAC (Descript Audio Codec), PyTorch.

Counterpart of ``audiocodecs_tpu/models/dac.py``, weight-compatible with its
param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`:

* encoder: conv7 stem → per stage [3 residual units (dilations 1, 3, 9,
  snake activations) → snake → strided conv k = 2s] with channel doubling →
  snake → conv3 projection to ``hidden_size``;
* quantizer: RVQ whose stages project ``hidden → codebook_dim`` (1×1),
  search by cosine similarity (unit-normed query and codebook, first
  maximum), and project back;
* decoder: conv7 → per stage [snake → transposed conv k = 2s → 3 residual
  units] → snake → conv7 → tanh.

Inside the stacks the layout is PyTorch's ``[B, C, T]``; all padding is
symmetric zero padding. The decoder's residual units with C ≤ 256 are built
fused: they call :func:`..ops.dac_resunit.dac_resunit`, which launches the
CUDA kernel for CUDA tensors and runs its plain version for CPU tensors.
Encoder units (their output decides the tokens) and wider decoder units run
unfused on every device (snake and ``F.conv1d``), as the reference leaves
them to XLA. The gate is fixed when a unit is built, from its role and
width.

The decoder computes in a :class:`DecodeForm`: the reference's serving
tiers, which it selects with environment switches (activation dtype, the
decoder's conv precision, the polynomial snake), are options given at
construction here (``DAC(..., decode_dtype, decode_precision,
snake_poly)``; :mod:`audiocodecs_tpu_torch.serving` picks them by family).
The encoder and the quantizer run exact fp32 in every form, so the tokens
do not depend on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import (
    Codec,
    CodecConfig,
    prune_params_for_mode,
)
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    _cached,
    conv1d,
    exact_fp32,
    unit_norm,
)
from audiocodecs_tpu_torch.ops.dac_resunit import (
    MAX_CHANNELS,
    dac_resunit,
    dac_resunit_reference,
    pack_resunit_weights,
)

__all__ = ["DAC", "DACModelConfig", "DecodeForm", "ResidualUnit",
           "dac_rvq_encode", "dac_rvq_decode", "init_dac_params",
           "residual_unit_io", "snake"]

DILATIONS = (1, 3, 9)

# cos(2πr) on r ∈ [-½, ½] as an even minimax polynomial in t = r², copied
# from the reference (``audiocodecs_tpu/models/dac.py``).
_SNAKE_COS_POLY = (
    0.99999998905902143, -19.739204499453951, 64.939117459897673,
    -85.450139530911997, 60.167630951117602, -25.967599248888114,
    6.5286581616462076,
)


def _snake_sin2_poly(y: torch.Tensor) -> torch.Tensor:
    """``sin²(y)`` = (1 − cos 2πr)/2 with r = y/π − round(y/π), cos 2πr
    from the polynomial by Horner, in ``y``'s dtype with 1/π and the
    coefficients rounded to it (the reference's ``_snake_sin2_poly``); each
    step is one tensor operation, rounded to ``y``'s dtype."""
    inv_pi, *coef = (float(torch.tensor(v, dtype=y.dtype))
                     for v in (1.0 / math.pi, *_SNAKE_COS_POLY))
    u = y * inv_pi
    r = u - torch.round(u)
    t = r * r
    cos2 = coef[-1] * t + coef[-2]
    for k in coef[-3::-1]:
        cos2 = cos2 * t + k
    return 0.5 - 0.5 * cos2


def snake(x: torch.Tensor, alpha: torch.Tensor,
          poly: bool = False) -> torch.Tensor:
    """Snake activation ``x + sin²(αx)/(α + 1e-9)`` over ``[B, C, T]`` in
    ``x``'s dtype (``alpha`` [C] of the same); ``poly`` takes sin² from
    :func:`_snake_sin2_poly`, the reference's XLA-path form
    (``ACX_SNAKE_APPROX=1``). The fused unit's kernel has its own form,
    :func:`..ops.dac_resunit.snake`."""
    a = alpha[:, None]
    if poly:
        return x + _snake_sin2_poly(a * x) / (a + 1e-9)
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


@dataclasses.dataclass(frozen=True)
class DACModelConfig:
    """Defaults = dac_16khz checkpoint."""

    sampling_rate: int = 16000
    encoder_hidden_size: int = 64
    downsampling_ratios: tuple[int, ...] = (2, 4, 5, 8)
    decoder_hidden_size: int = 1536
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    hidden_size: int = 1024
    n_codebooks: int = 12
    codebook_size: int = 1024
    codebook_dim: int = 8

    @property
    def hop_length(self) -> int:
        return math.prod(self.downsampling_ratios)


def _conv(x, p: Conv1d, *, stride: int = 1, pad: int = 0):
    """Symmetric zero pad, then a valid conv."""
    if pad:
        x = F.pad(x, (pad, pad))
    return conv1d(x, p.w, p.b, stride=stride)


def _proj(x, p: Conv1d):
    """1×1 conv over the last axis (``[..., Cin]`` → ``[..., Cout]``)."""
    with exact_fp32():
        return torch.matmul(x, p.w[:, :, 0].T) + p.b


def fused_resunit(role: str, channels: int) -> bool:
    """The kernel gate: decoder units of at most 256 channels (the
    reference's ``auto`` rule, fixed at build time)."""
    return role == "decoder" and channels <= MAX_CHANNELS


class ResidualUnit(nn.Module):
    """snake → dilated conv7 → snake → conv1, plus the input, in a
    :class:`DecodeForm` (exact fp32 by default).

    A fused unit keeps its conv weights in the kernel's layout for its
    form's precision (:func:`..ops.dac_resunit.pack_resunit_weights`),
    built on its first forward and again only when the form or ``conv1.w``
    or ``conv2.w`` changes: moves to another device, or is written in place
    (``load_state_dict`` and an optimizer's step bump the tensor's
    version). The packed pair is no parameter or buffer, so the state dict
    is unchanged."""

    def __init__(self, ch: int, dilation: int, fused: bool,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        self.alpha1 = nn.Parameter(torch.empty(ch))
        self.conv1 = Conv1d(ch, ch, 7)
        self.alpha2 = nn.Parameter(torch.empty(ch))
        self.conv2 = Conv1d(ch, ch, 1)
        self.dilation = dilation
        self.fused = fused
        self.form = form

    def packed_weights(self):
        """The kernel's layout of (conv1.w, conv2.w) for the form's
        precision, rebuilt only when the precision or either weight's
        (device, data_ptr, version) changed."""
        precision = self.form.precision
        return _cached(
            self, "packed", precision,
            lambda w7, w1: pack_resunit_weights(w7, w1, precision),
            (self.conv1.w, self.conv2.w))

    def forward(self, x):
        f = self.form
        if self.fused:
            # the transposed conv's trim leaves a strided view
            return dac_resunit(
                x.contiguous(), f.param(self.conv1, "w"),
                f.param(self.conv1, "b"), f.param(self, "alpha1"),
                f.param(self.conv2, "w"), f.param(self.conv2, "b"),
                f.param(self, "alpha2"), self.dilation,
                precision=f.precision, snake_poly=f.snake_poly,
                packed=self.packed_weights())
        if f.exact:
            return dac_resunit_reference(x, self.conv1.w, self.conv1.b,
                                         self.alpha1, self.conv2.w,
                                         self.conv2.b, self.alpha2,
                                         self.dilation)
        h = snake(x, f.param(self, "alpha1"), f.snake_poly)
        h = f.conv1d(h, self.conv1, dilation=self.dilation,
                     pad=3 * self.dilation)
        h = snake(h, f.param(self, "alpha2"), f.snake_poly)
        return x + f.conv1d(h, self.conv2)


@contextlib.contextmanager
def residual_unit_io(module: nn.Module):
    """Yields two dicts, filled with the input and the output of each
    :class:`ResidualUnit` in ``module`` (by its name there) as the units
    run inside ``with``: a check can then feed one device's unit the input
    that another device's unit got."""
    ins, outs, hooks = {}, {}, []
    for name, m in module.named_modules():
        if isinstance(m, ResidualUnit):
            def keep(unit, args, out, name=name):
                ins[name], outs[name] = args[0].detach(), out.detach()
            hooks.append(m.register_forward_hook(keep))
    try:
        yield ins, outs
    finally:
        for h in hooks:
            h.remove()


def _units(ch: int, role: str,
           form: DecodeForm = DecodeForm()) -> nn.ModuleList:
    return nn.ModuleList(ResidualUnit(ch, d, fused_resunit(role, ch), form)
                         for d in DILATIONS)


class EncoderBlock(nn.Module):
    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.res = _units(ch, "encoder")
        self.alpha_down = nn.Parameter(torch.empty(ch))
        self.conv_down = Conv1d(ch, 2 * ch, 2 * stride)
        self.stride = stride

    def forward(self, x):
        for unit in self.res:
            x = unit(x)
        x = snake(x, self.alpha_down)
        return _conv(x, self.conv_down, stride=self.stride,
                     pad=math.ceil(self.stride / 2))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        self.alpha_up = nn.Parameter(torch.empty(cin))
        self.convtr = ConvTranspose1d(cin, cout, 2 * stride)
        self.res = _units(cout, "decoder", form)
        self.stride = stride
        self.form = form

    def forward(self, x):
        f = self.form
        x = snake(x, f.param(self, "alpha_up"), f.snake_poly)
        x = f.conv_transpose1d(x, self.convtr, stride=self.stride)
        pad = math.ceil(self.stride / 2)
        x = x[..., pad: x.shape[-1] - pad]
        for unit in self.res:
            x = unit(x)
        return x


class Encoder(nn.Module):
    """``[B, 1, T]`` → ``[B, hidden, N]``."""

    def __init__(self, cfg: DACModelConfig):
        super().__init__()
        ch = cfg.encoder_hidden_size
        self.conv_in = Conv1d(1, ch, 7)
        blocks = []
        for stride in cfg.downsampling_ratios:
            blocks.append(EncoderBlock(ch, stride))
            ch *= 2
        self.blocks = nn.ModuleList(blocks)
        self.alpha_out = nn.Parameter(torch.empty(ch))
        self.conv_out = Conv1d(ch, cfg.hidden_size, 3)

    def forward(self, x):
        h = _conv(x, self.conv_in, pad=3)
        for block in self.blocks:
            h = block(h)
        return _conv(snake(h, self.alpha_out), self.conv_out, pad=1)


class Decoder(nn.Module):
    """``[B, hidden, N]`` → ``[B, 1, T]`` float32, computed in ``form``."""

    def __init__(self, cfg: DACModelConfig,
                 form: DecodeForm = DecodeForm()):
        super().__init__()
        dim = cfg.decoder_hidden_size
        self.conv_in = Conv1d(cfg.hidden_size, dim, 7)
        self.blocks = nn.ModuleList(
            DecoderBlock(dim // 2**i, dim // 2 ** (i + 1), stride, form)
            for i, stride in enumerate(cfg.upsampling_ratios))
        out_dim = dim // 2 ** len(cfg.upsampling_ratios)
        self.alpha_out = nn.Parameter(torch.empty(out_dim))
        self.conv_out = Conv1d(out_dim, 1, 7)
        self.form = form

    def forward(self, q):
        f = self.form
        h = f.conv1d(q.to(f.dtype), self.conv_in, pad=3)
        for block in self.blocks:
            h = block(h)
        h = snake(h, f.param(self, "alpha_out"), f.snake_poly)
        return torch.tanh(f.conv1d(h, self.conv_out, pad=3)).float()


class QuantizerStage(nn.Module):
    def __init__(self, cfg: DACModelConfig):
        super().__init__()
        self.in_proj = Conv1d(cfg.hidden_size, cfg.codebook_dim, 1)
        self.out_proj = Conv1d(cfg.codebook_dim, cfg.hidden_size, 1)
        self.codebook = nn.Parameter(
            torch.empty(cfg.codebook_size, cfg.codebook_dim))


def dac_rvq_encode(feats: torch.Tensor, quantizers, K: int) -> torch.Tensor:
    """Projected cosine-similarity RVQ: ``[B, N, H]`` → tokens ``[B, N, K]``
    (int64). Scores are dot products of unit vectors in fp32."""
    residual = feats
    toks = []
    with exact_fp32():
        for q in list(quantizers)[:K]:
            zn = unit_norm(_proj(residual, q.in_proj))
            cb = unit_norm(q.codebook)
            idx = torch.argmax(torch.matmul(zn, cb.T), dim=-1)
            toks.append(idx)
            residual = residual - _proj(q.codebook[idx], q.out_proj)
    return torch.stack(toks, dim=-1)


def dac_rvq_decode(toks: torch.Tensor, quantizers) -> torch.Tensor:
    """Tokens ``[B, N, K]`` → quantized features ``[B, N, hidden]``."""
    out = None
    for k in range(toks.shape[-1]):
        q = quantizers[k]
        y = _proj(q.codebook[toks[..., k]], q.out_proj)
        out = y if out is None else out + y
    return out


class DAC(Codec):
    """DAC codec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract.

    ``num_codebooks`` selects the first K RVQ stages. ``latent`` makes
    ``sig_to_feats`` return the first stage's projection and ``embs()`` the
    raw codebooks. ``state_dict`` (e.g. from
    :func:`audiocodecs_tpu_torch.params.from_jax_params`) is loaded
    strictly; without it the weights are drawn by :func:`init_dac_params`
    from ``generator`` (seed 0 by default). ``device=None`` means the card.
    ``decode_dtype``, ``decode_precision`` and ``snake_poly`` are the
    decoder's :class:`DecodeForm` (a serving tier; exact fp32 by default).
    """

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        """Per-rate architectures of the released descript checkpoints."""
        if orig_sample_rate >= 44000:
            return DACModelConfig(
                sampling_rate=orig_sample_rate,
                downsampling_ratios=(2, 4, 8, 8),  # hop 512 → 86 Hz
                upsampling_ratios=(8, 8, 4, 2),
                n_codebooks=9,
            )
        if orig_sample_rate >= 24000:
            return DACModelConfig(
                sampling_rate=orig_sample_rate,
                downsampling_ratios=(2, 4, 5, 8),  # hop 320 → 75 Hz
                upsampling_ratios=(8, 5, 4, 2),
                n_codebooks=32,
            )
        return DACModelConfig(sampling_rate=orig_sample_rate)  # 16 kHz, K=12

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        latent: bool = False,
        model_config: Optional[DACModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        snake_poly: bool = False,
    ):
        form = DecodeForm(decode_dtype, decode_precision, snake_poly)
        mc = model_config or self.default_model_config(orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.latent = latent
        self.decode_form = form
        if mode != "decode":
            self.encoder = Encoder(mc)
        if mode != "encode":
            self.decoder = Decoder(mc, form)
        self.quantizer = nn.ModuleList(
            QuantizerStage(mc) for _ in range(mc.n_codebooks))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_dac_params(generator, mc)
        self.load_state_dict(prune_params_for_mode(state_dict, mode),
                             strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode_feats(self, sig, length):
        del length  # masking is caller-side padding
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_feats(self, sig, length):
        feats = self._encode_feats(sig, length)
        if self.latent:
            feats = _proj(feats, self.quantizer[0].in_proj)
        return feats

    def _sig_to_toks(self, sig, length):
        return dac_rvq_encode(self._encode_feats(sig, length), self.quantizer,
                              self.config.num_codebooks)

    def _sig_to_qfeats(self, sig, length):
        return dac_rvq_decode(self._sig_to_toks(sig, length), self.quantizer)

    def _toks_to_qfeats(self, toks, length):
        return dac_rvq_decode(toks, self.quantizer)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(dac_rvq_decode(toks, self.quantizer),
                                  length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))[:, 0]

    def embs(self) -> torch.Tensor:
        """``[K, C, D]`` raw (latent) or ``[K, C, H]`` post-projection
        codebooks of the used stages."""
        qs = list(self.quantizer)[: self.config.num_codebooks]
        with torch.inference_mode():
            if self.latent:
                return torch.stack([q.codebook for q in qs])
            return torch.stack([_proj(q.codebook, q.out_proj) for q in qs])


def init_dac_params(generator: torch.Generator, cfg: DACModelConfig) -> dict:
    """Random weights as a flat state dict, in the reference package's
    distributions (conv weights N(0, 0.02²), zero biases, α = 1, codebooks
    N(0, 0.02²)); the draws differ from the reference's."""
    out = {}

    def conv(name, cin, cout, k, transposed=False):
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        out[f"{name}.w"] = torch.randn(shape, generator=generator) * 0.02
        out[f"{name}.b"] = torch.zeros(cout)

    def units(prefix, ch):
        for ri in range(len(DILATIONS)):
            p = f"{prefix}.res.{ri}"
            out[f"{p}.alpha1"] = torch.ones(ch)
            conv(f"{p}.conv1", ch, ch, 7)
            out[f"{p}.alpha2"] = torch.ones(ch)
            conv(f"{p}.conv2", ch, ch, 1)

    ch = cfg.encoder_hidden_size
    conv("encoder.conv_in", 1, ch, 7)
    for i, stride in enumerate(cfg.downsampling_ratios):
        units(f"encoder.blocks.{i}", ch)
        out[f"encoder.blocks.{i}.alpha_down"] = torch.ones(ch)
        conv(f"encoder.blocks.{i}.conv_down", ch, 2 * ch, 2 * stride)
        ch *= 2
    out["encoder.alpha_out"] = torch.ones(ch)
    conv("encoder.conv_out", ch, cfg.hidden_size, 3)

    dim = cfg.decoder_hidden_size
    conv("decoder.conv_in", cfg.hidden_size, dim, 7)
    for i, stride in enumerate(cfg.upsampling_ratios):
        cin, cout = dim // 2**i, dim // 2 ** (i + 1)
        out[f"decoder.blocks.{i}.alpha_up"] = torch.ones(cin)
        conv(f"decoder.blocks.{i}.convtr", cin, cout, 2 * stride,
             transposed=True)
        units(f"decoder.blocks.{i}", cout)
    out_dim = dim // 2 ** len(cfg.upsampling_ratios)
    out["decoder.alpha_out"] = torch.ones(out_dim)
    conv("decoder.conv_out", out_dim, 1, 7)

    for k in range(cfg.n_codebooks):
        conv(f"quantizer.{k}.in_proj", cfg.hidden_size, cfg.codebook_dim, 1)
        conv(f"quantizer.{k}.out_proj", cfg.codebook_dim, cfg.hidden_size, 1)
        out[f"quantizer.{k}.codebook"] = torch.randn(
            (cfg.codebook_size, cfg.codebook_dim), generator=generator) * 0.02
    return out

