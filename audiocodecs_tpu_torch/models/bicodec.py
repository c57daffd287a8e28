"""BiCodec (Spark-TTS's dual-stream codec), PyTorch.

Counterpart of ``audiocodecs_tpu/models/bicodec.py``
(``SparkAudio/Spark-TTS-0.5B``), weight-compatible with its param tree
through :func:`audiocodecs_tpu_torch.params.from_jax_params`. One token
grid of two streams, 32 global tokens first, then the semantic frames:

* semantic (50 Hz): the utterance zero-meaned and scaled to unit variance
  → wav2vec2-large-XLSR-53 (:mod:`..nn.wavlm`, plain attention), the mean
  of hidden states 11, 14 and 16 (the tower runs to 16 and no further) →
  a Vocos-ConvNeXt encoder (384 wide, 12 blocks) → 1024 → a factorized
  cosine VQ (``in_proj`` to 8, unit-normed search over 8192 codes, the
  first maximum);
* global: the magnitude mel (n_fft 1024, a 640-sample Hann window centred
  in it, hop 320, reflect padded by 352 a side, 100 Slaney bins from 10 Hz)
  → ECAPA-TDNN's frames (:mod:`..nn.ecapa`, 3 × 512) → a perceiver
  resampler to 32 latents of 128 (:mod:`..nn.perceiver`) → a 6-d FSQ of
  levels 4⁶ (4096 ids).

Decode: the semantic codes through ``out_proj``; the d-vector from the
global ids (FSQ codes → ``project_out`` → the 32 latents flattened →
``project`` to 1024); a Vocos prenet with continuous AdaLN on the d-vector
(:class:`..nn.vocos.AdaNormCont`) → 1024, plus the d-vector; then the
DAC-lineage WaveGenerator: a conv7 to 1536, four blocks of snake →
transposed conv (rates 8, 5, 4, 2, kernels 16, 11, 8, 4, trimmed by
(k − s)/2) → three DAC residual units (dilations 1, 3, 9) at 768, 384,
192 and 96 channels, then snake → conv7 → tanh: 16 kHz.

The residual units are DAC's (:class:`..models.dac.ResidualUnit`), gated
as DAC's decoder units: those of at most 256 channels (C = 192 and 96)
launch the fused unit kernel in its exact form on the card, six a decode;
the 768- and 384-channel units run unfused. The reference runs these
units on XLA, for it opens no decoder scope in the generator; the kernel's
exact form computes the same function (its error against the plain version
is at fp32 rounding), and the generator only decodes, so no token can
move.

Everything runs in exact fp32 (TF32 off). ``decode_dtype`` and
``decode_precision`` (a serving tier's arguments) are taken and checked
but change nothing: the reference's BiCodec reads no activation dtype and
opens no decoder scope, so it decodes exactly in every tier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.models.dac import (
    DILATIONS,
    ResidualUnit,
    _conv,
    fused_resunit,
    snake,
)
from audiocodecs_tpu_torch.nn.ecapa import (
    Ecapa,
    EcapaConfig,
    apply_ecapa,
    init_ecapa_params,
)
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    conv_transpose1d,
    exact_fp32,
    init_conv,
    unit_norm,
)
from audiocodecs_tpu_torch.nn.perceiver import (
    Perceiver,
    PerceiverConfig,
    apply_perceiver,
    init_perceiver_params,
)
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear
from audiocodecs_tpu_torch.nn.vocos import (
    Vocos,
    VocosConfig,
    apply_vocos_backbone,
    init_vocos_backbone_params,
)
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
    wav2vec2_xlsr_config,
)
from audiocodecs_tpu_torch.quant.fsq import (
    fsq_codes_to_indices,
    fsq_indices_to_codes,
    fsq_quantize,
)
from audiocodecs_tpu_torch.utils.melbank import mel_filterbank_slaney

__all__ = ["BiCodec", "BiCodecModelConfig", "NUM_GLOBAL_TOKENS",
           "init_bicodec_params"]

NUM_GLOBAL_TOKENS = 32


@dataclasses.dataclass(frozen=True)
class BiCodecModelConfig:
    sampling_rate: int = 16000
    w2v: WavLMConfig = dataclasses.field(default_factory=wav2vec2_xlsr_config)
    feat_layers: tuple[int, ...] = (11, 14, 16)
    encoder_dim: int = 384
    encoder_intermediate_dim: int = 2048
    encoder_layers: int = 12
    latent_dim: int = 1024
    codebook_size: int = 8192
    codebook_dim: int = 8
    num_mels: int = 100
    n_fft: int = 1024
    win_length: int = 640
    hop_length: int = 320
    mel_fmin: float = 10.0
    speaker_channels: int = 512
    speaker_dim: int = 1024  # ECAPA's embedding, the d-vector
    perceiver_dim: int = 128
    perceiver_depth: int = 2
    num_global_tokens: int = NUM_GLOBAL_TOKENS
    fsq_levels: tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    prenet_dim: int = 384
    prenet_intermediate_dim: int = 2048
    prenet_layers: int = 12
    decoder_channels: int = 1536
    decoder_rates: tuple[int, ...] = (8, 5, 4, 2)
    decoder_kernels: tuple[int, ...] = (16, 11, 8, 4)

    def encoder_vocos(self) -> VocosConfig:
        return VocosConfig(
            input_channels=self.w2v.hidden_size, dim=self.encoder_dim,
            intermediate_dim=self.encoder_intermediate_dim,
            num_layers=self.encoder_layers, num_adanorm_embeddings=None)

    def prenet_vocos(self) -> VocosConfig:
        return VocosConfig(
            input_channels=self.latent_dim, dim=self.prenet_dim,
            intermediate_dim=self.prenet_intermediate_dim,
            num_layers=self.prenet_layers, num_adanorm_embeddings=None)

    def ecapa(self) -> EcapaConfig:
        return EcapaConfig(feat_dim=self.num_mels,
                           channels=self.speaker_channels,
                           embed_dim=self.speaker_dim)

    def perceiver(self) -> PerceiverConfig:
        return PerceiverConfig(
            dim=self.perceiver_dim, depth=self.perceiver_depth,
            num_latents=self.num_global_tokens,
            dim_context=3 * self.speaker_channels)


class _Head(nn.Module):
    """A Vocos backbone and a linear ``project`` after it."""

    def __init__(self, cfg: VocosConfig, out: int,
                 cond_dim: Optional[int] = None):
        super().__init__()
        self.backbone = Vocos(cfg, head=False, cond_dim=cond_dim)
        self.project = Linear(cfg.dim, out, True)


class _Quantizer(nn.Module):
    def __init__(self, cfg: BiCodecModelConfig):
        super().__init__()
        H, D = cfg.latent_dim, cfg.codebook_dim
        self.in_proj = Linear(H, D, True)
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size, D))
        self.out_proj = Linear(D, H, True)


class _SpeakerFSQ(nn.Module):
    def __init__(self, cfg: BiCodecModelConfig):
        super().__init__()
        P, L = cfg.perceiver_dim, len(cfg.fsq_levels)
        self.project_in = Linear(P, L, True)
        self.project_out = Linear(L, P, True)
        self.project = Linear(P * cfg.num_global_tokens, cfg.speaker_dim,
                              True)


class _GeneratorBlock(nn.Module):
    """snake → transposed conv (k, stride s) trimmed by (k − s)/2 → three
    residual units at half the width."""

    def __init__(self, cin: int, stride: int, k: int):
        super().__init__()
        out = cin // 2
        self.alpha = nn.Parameter(torch.empty(cin))
        self.convtr = ConvTranspose1d(cin, out, k)
        self.res = nn.ModuleList(
            ResidualUnit(out, d, fused_resunit("decoder", out))
            for d in DILATIONS)
        self.stride = stride

    def forward(self, x):
        s, k = self.stride, self.convtr.w.shape[-1]
        y = conv_transpose1d(snake(x, self.alpha), self.convtr.w,
                             self.convtr.b, stride=s)
        pad = (k - s) // 2
        x = y[..., pad: y.shape[-1] - (k - s - pad)]
        for unit in self.res:
            x = unit(x)
        return x


class _Generator(nn.Module):
    """``[B, latent, N]`` → ``[B, N · hop]``."""

    def __init__(self, cfg: BiCodecModelConfig):
        super().__init__()
        ch = cfg.decoder_channels
        self.stem = Conv1d(cfg.latent_dim, ch, 7)
        blocks = []
        for s, k in zip(cfg.decoder_rates, cfg.decoder_kernels):
            blocks.append(_GeneratorBlock(ch, s, k))
            ch //= 2
        self.blocks = nn.ModuleList(blocks)
        self.alpha_out = nn.Parameter(torch.empty(ch))
        self.conv_out = Conv1d(ch, 1, 7)

    def forward(self, h):
        x = _conv(h, self.stem, pad=3)
        for block in self.blocks:
            x = block(x)
        x = _conv(snake(x, self.alpha_out), self.conv_out, pad=3)
        return torch.tanh(x)[:, 0]


class BiCodec(Codec):
    """BiCodec with the standardized contract: ``[B, T]`` ↔ ``[B, 32 + N,
    1]`` (32 global tokens, then N semantic frames at 50 Hz).

    ``sig_to_feats`` is the pre-VQ semantic latent beside the d-vector of
    the global tokens, broadcast over the frames (``[B, N, 2 · 1024]``);
    ``toks_to_qfeats`` is the same of the quantized stream;
    ``feats_to_sig`` decodes such features, the d-vector averaged over the
    frames. ``state_dict`` is loaded strictly; without it the weights are
    drawn by :func:`init_bicodec_params` from ``generator`` (seed 0 by
    default). Encode mode drops the prenet and the generator; decode mode
    the tower, the encoder, ECAPA and the perceiver. ``device=None`` means
    the card."""

    # the reference keeps snake's α as [1, 1, C]; the bridge restores it
    JAX_ALPHA_SHAPE = (1, 1, -1)

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return BiCodecModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        model_config: Optional[BiCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        if num_codebooks != 1:
            raise ValueError("BiCodec is single-codebook (K=1)")
        mc = model_config or BiCodecModelConfig(sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        if mode != "decode":
            self.w2v = WavLM(mc.w2v)
            self.encoder = _Head(mc.encoder_vocos(), mc.latent_dim)
            self.ecapa = Ecapa(mc.ecapa())
            self.perceiver = Perceiver(mc.perceiver())
        self.quantizer = _Quantizer(mc)
        self.speaker_fsq = _SpeakerFSQ(mc)
        if mode != "encode":
            self.prenet = _Head(mc.prenet_vocos(), mc.latent_dim,
                                cond_dim=mc.speaker_dim)
            self.decoder = _Generator(mc)
        fb = mel_filterbank_slaney(mc.sampling_rate, mc.n_fft, mc.num_mels,
                                   mc.mel_fmin, mc.sampling_rate / 2)
        self.register_buffer("_mel_fb", torch.from_numpy(fb),
                             persistent=False)
        n, w = mc.n_fft, mc.win_length
        win = np.zeros(n, np.float32)
        win[(n - w) // 2: (n - w) // 2 + w] = np.hanning(w + 1)[:-1]
        self.register_buffer("_window", torch.from_numpy(win),
                             persistent=False)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_bicodec_params(generator, mc)
        drop = {"encode": ("prenet.", "decoder."),
                "decode": ("w2v.", "encoder.", "ecapa.", "perceiver.")}.get(
                    mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Encode --------------------------------------------------------------- #

    def _semantic_z(self, sig):
        """``[B, T]`` → the pre-VQ semantic latent ``[B, N, latent]``."""
        mc = self.model_config
        mean = torch.mean(sig, dim=-1, keepdim=True)
        var = torch.mean((sig - mean) ** 2, dim=-1, keepdim=True)
        x = (sig - mean) / torch.sqrt(var + 1e-7)
        hs = apply_wavlm(self.w2v, x, mc.w2v, output_layer=max(mc.feat_layers),
                         output_hidden_states=True)
        feats = torch.mean(torch.stack([hs[i] for i in mc.feat_layers]),
                           dim=0)
        h = apply_vocos_backbone(self.encoder.backbone, feats,
                                 mc.encoder_vocos())
        return _linear(h, self.encoder.project)

    def _semantic_tokens(self, z):
        """Cosine search: the first maximal code a frame, ``[B, N]``."""
        q = self.quantizer
        e = unit_norm(_linear(z, q.in_proj))
        with exact_fp32():
            scores = torch.matmul(e, unit_norm(q.codebook).T)
        return torch.argmax(scores, dim=-1)

    def _mel(self, sig):
        """The magnitude mel ``[B, frames, num_mels]``."""
        mc = self.model_config
        n, h = mc.n_fft, mc.hop_length
        pad = (n - h) // 2
        x = F.pad(sig[:, None], (pad, pad), mode="reflect")[:, 0]
        frames = x.unfold(-1, n, h) * self._window  # [B, F, n]
        spec = torch.abs(torch.fft.rfft(frames, dim=-1))
        with exact_fp32():
            return torch.matmul(spec, self._mel_fb.T)

    def _global_latents(self, sig):
        """The speaker FSQ's input ``[B, 32, levels]`` (before bounding)."""
        mc = self.model_config
        _, frames = apply_ecapa(self.ecapa, self._mel(sig), mc.ecapa(),
                                return_frames=True)
        lat = apply_perceiver(self.perceiver, frames, mc.perceiver())
        return _linear(lat, self.speaker_fsq.project_in)

    def _global_tokens(self, sig):
        levels = self.model_config.fsq_levels
        codes = fsq_quantize(self._global_latents(sig), levels)
        return fsq_codes_to_indices(codes, levels)  # [B, 32]

    def _sig_to_toks(self, sig, length):
        del length
        sem = self._semantic_tokens(self._semantic_z(sig))
        return torch.cat([self._global_tokens(sig), sem], dim=1)[..., None]

    def _split(self, toks):
        g = self.model_config.num_global_tokens
        return toks[:, :g, 0], toks[:, g:, 0]

    # Decode --------------------------------------------------------------- #

    def _dequant_semantic(self, sem):
        q = self.quantizer
        return _linear(q.codebook[sem], q.out_proj)

    def _d_vector(self, glob):
        s = self.speaker_fsq
        codes = fsq_indices_to_codes(glob, self.model_config.fsq_levels)
        lat = _linear(codes, s.project_out)  # [B, 32, perceiver_dim]
        return _linear(lat.reshape(lat.shape[0], -1), s.project)

    def _wave(self, z_q, d_vector):
        mc = self.model_config
        h = apply_vocos_backbone(self.prenet.backbone, z_q, mc.prenet_vocos(),
                                 cond=d_vector)
        h = _linear(h, self.prenet.project) + d_vector[:, None, :]
        return self.decoder(h.transpose(1, 2))

    def _toks_to_sig(self, toks, length):
        glob, sem = self._split(toks)
        return self._wave(self._dequant_semantic(sem), self._d_vector(glob))

    def _sig_to_feats(self, sig, length):
        del length
        z = self._semantic_z(sig)
        d = self._d_vector(self._global_tokens(sig))
        return torch.cat([z, d[:, None].expand_as(z)], dim=-1)

    def _toks_to_qfeats(self, toks, length):
        glob, sem = self._split(toks)
        z_q = self._dequant_semantic(sem)
        d = self._d_vector(glob)
        return torch.cat([z_q, d[:, None].expand_as(z_q)], dim=-1)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _feats_to_sig(self, feats, length):
        H = self.model_config.latent_dim
        return self._wave(feats[..., :H], torch.mean(feats[..., H:], dim=1))

    def embs(self) -> torch.Tensor:
        """The semantic codebook ``[1, 8192, codebook_dim]``."""
        return self.quantizer.codebook.detach()[None]


def init_bicodec_params(generator: torch.Generator,
                        cfg: BiCodecModelConfig) -> dict:
    """Random weights of :class:`BiCodec` as a flat state dict, in the
    reference's distributions (each submodule's init; linears and convs
    N(0, 1) · fan_in^-½ with zero biases, the codebook N(0, 1), snake α 1)
    but for each generator unit's closing 1×1 conv, drawn at a tenth of
    that scale, as BigCodec's (:func:`..models.bigcodec.
    init_codec_encoder_params`): at unit gain the twelve residual adds grow
    the activations to where tanh saturates 84 % of the decoded samples at
    the published width, and two correct fp32 decodes part by 5e-4 of
    max|sig| (the port's own float64 decode against its float32 one). The
    draws differ from the reference's."""
    H, D, P = cfg.latent_dim, cfg.codebook_dim, cfg.perceiver_dim
    L = len(cfg.fsq_levels)
    out = init_wavlm_params(generator, cfg.w2v, "w2v.")

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=generator) * i ** -.5
        out[f"{name}.b"] = torch.zeros(o)

    out.update({f"encoder.backbone.{k}": v for k, v in
                init_vocos_backbone_params(generator,
                                           cfg.encoder_vocos()).items()})
    lin("encoder.project", cfg.encoder_dim, H)
    lin("quantizer.in_proj", H, D)
    out["quantizer.codebook"] = torch.randn((cfg.codebook_size, D),
                                            generator=generator)
    lin("quantizer.out_proj", D, H)
    out.update(init_ecapa_params(generator, cfg.ecapa(), "ecapa."))
    out.update(init_perceiver_params(generator, cfg.perceiver(),
                                     "perceiver."))
    lin("speaker_fsq.project_in", P, L)
    lin("speaker_fsq.project_out", L, P)
    lin("speaker_fsq.project", P * cfg.num_global_tokens, cfg.speaker_dim)
    out.update({f"prenet.backbone.{k}": v for k, v in
                init_vocos_backbone_params(generator, cfg.prenet_vocos(),
                                           cond_dim=cfg.speaker_dim).items()})
    lin("prenet.project", cfg.prenet_dim, H)
    ch = cfg.decoder_channels
    init_conv(out, generator, "decoder.stem", H, ch, 7)
    for i, k in enumerate(cfg.decoder_kernels):
        p = f"decoder.blocks.{i}"
        out[f"{p}.alpha"] = torch.ones(ch)
        init_conv(out, generator, f"{p}.convtr", ch, ch // 2, k,
                  transposed=True)
        ch //= 2
        for j in range(len(DILATIONS)):
            r = f"{p}.res.{j}"
            out[f"{r}.alpha1"] = torch.ones(ch)
            init_conv(out, generator, f"{r}.conv1", ch, ch, 7)
            out[f"{r}.alpha2"] = torch.ones(ch)
            init_conv(out, generator, f"{r}.conv2", ch, ch, 1, gain=0.1)
    out["decoder.alpha_out"] = torch.ones(ch)
    init_conv(out, generator, "decoder.conv_out", ch, 1, 7)
    return out
