"""X-Codec 2.0, PyTorch.

Counterpart of ``audiocodecs_tpu/models/xcodec2.py`` (``HKUST-Audio/
xcodec2``), weight-compatible with its param tree through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. A single-token 50 Hz
codec at 16 kHz with two encoder branches:

* acoustic: BigCodec's encoder (:class:`..models.bigcodec.CodecEncoder`,
  reused) at hop 2·2·4·4·5 = 320: snake residual units, then the 2-layer
  residual LSTM at H = 1536, which runs the recurrence kernel's wide
  instance (one launch a layer for every 8 batch rows), then a conv to
  1024;
* semantic: w2v-BERT 2.0's hidden state 16 (:mod:`..nn.w2vbert`) over the
  SeamlessM4T mels of the waveform padded by 160 samples a side (so both
  branches land on one 50 Hz grid), refined by the residual conv
  ``SemanticEncoder`` to 1024;

fused by channel concatenation (semantic first) and ``fc_prior`` (2048 →
2048), quantized by one FSQ of levels (4,)×8 between ``project_in``
(2048 → 8) and ``project_out`` (8 → 2048): 4⁸ = 65,536 tokens. The decoder:
``fc_post_a`` (2048 → 1024), a k7 embed conv, LayerNorm, a 12-block
RoFormer (16 heads, gated, GELU), LayerNorm, a linear head to n_fft + 2,
``exp`` of the magnitude (clamped at 100) and ``cos``/``sin`` of the phase,
and the inverse STFT (n_fft 1280, hop 320, ``padding="same"``,
:func:`..nn.vocos.istft`). ``fc_post_s`` (the semantic reconstruction head)
is carried for the weights' sake and never run.

The encoders, w2v-BERT and the FSQ projections run in exact fp32 (TF32
off). ``decode_dtype`` and ``decode_precision`` (a serving tier's
arguments) set the decoder's :class:`..nn.layers.DecodeForm` as the
reference's switches do, where its decoder runs inside
``conv_role("decoder")``: fp32 activations at
``decode_precision="default"`` (its ``ACX_DEC_CONV_PRECISION=default``) run
the decoder's embed conv and its RoFormer products (the linears
``fc_post_a`` and ``head`` stay exact, as the reference gives them no
precision) on bf16-rounded operands with fp32 sums, one bf16 pass. The
reference's X-Codec 2.0 reads no activation dtype but its BigCodec
encoder's (fp32), so bf16 activations (the EnCodec-style tier, which sets
no decoder precision) decode exactly, as at the default. The reference's
bf16 activations together with ``ACX_DEC_CONV_PRECISION=default`` have no
name among the port's arguments, and no preset reaches them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.models.bigcodec import (
    BigCodecModelConfig,
    CodecEncoder,
    init_codec_encoder_params,
)
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    DecodeForm,
    conv1d,
    init_conv,
)
from audiocodecs_tpu_torch.nn.roformer import (
    Roformer,
    RoformerConfig,
    apply_roformer,
    init_roformer_params,
)
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, _linear, _norm
from audiocodecs_tpu_torch.nn.vocos import istft
from audiocodecs_tpu_torch.nn.w2vbert import (
    W2VBert,
    W2VBertConfig,
    apply_w2vbert,
    init_w2vbert_params,
    w2vbert_features,
)
from audiocodecs_tpu_torch.quant.fsq import (
    fsq_codes_to_indices,
    fsq_implicit_codebook,
    fsq_indices_to_codes,
    fsq_quantize,
)

__all__ = ["XCodec2", "XCodec2ModelConfig", "init_xcodec2_params"]


@dataclasses.dataclass(frozen=True)
class XCodec2ModelConfig:
    sampling_rate: int = 16000
    ngf: int = 48
    up_ratios: tuple[int, ...] = (2, 2, 4, 4, 5)  # hop 320 → 50 Hz
    dilations: tuple[int, ...] = (1, 3, 9)
    acoustic_dim: int = 1024
    semantic_dim: int = 1024
    fused_dim: int = 2048
    levels: tuple[int, ...] = (4, 4, 4, 4, 4, 4, 4, 4)  # 4^8 = 65536
    w2vbert: W2VBertConfig = dataclasses.field(default_factory=W2VBertConfig)
    semantic_layer: int = 16
    backbone_depth: int = 12
    backbone_heads: int = 16
    n_fft: int = 1280
    hop_length: int = 320

    def encoder(self) -> BigCodecModelConfig:
        return BigCodecModelConfig(
            sampling_rate=self.sampling_rate,
            ngf=self.ngf,
            up_ratios=self.up_ratios,
            dilations=self.dilations,
            hidden_size=self.acoustic_dim,
        )

    def backbone(self) -> RoformerConfig:
        head_dim = self.acoustic_dim // self.backbone_heads
        return RoformerConfig(
            dim=self.acoustic_dim,
            depth=self.backbone_depth,
            num_heads=self.backbone_heads,
            rope_dim=min(64, head_dim),
        )

    @property
    def vocab_size(self) -> int:
        return math.prod(self.levels)


def _ln(x, p: Norm):
    return _norm(x, p, "layernorm", 1e-6)


def _conv_same(x, conv: Conv1d):
    """Zero pad (k − 1)/2 a side, then valid: ``[B, C, N]`` keeps N."""
    pad = (conv.w.shape[-1] - 1) // 2
    return conv1d(F.pad(x, (pad, pad)), conv.w, conv.b)


class _SemanticEncoder(nn.Module):
    """The vendor's ``SemanticEncoder``: conv3 → (ReLU conv3)×2 residual →
    conv3, on ``[B, N, C]``."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.init = Conv1d(cin, dim, 3)
        self.res1 = Conv1d(dim, dim, 3)
        self.res2 = Conv1d(dim, dim, 3)
        self.final = Conv1d(dim, dim, 3)

    def forward(self, x):
        h = _conv_same(x.transpose(1, 2), self.init)
        r = _conv_same(torch.relu(h), self.res1)
        r = _conv_same(torch.relu(r), self.res2)
        return _conv_same(h + r, self.final).transpose(1, 2)


class _Quantizer(nn.Module):
    def __init__(self, fused: int, dim: int):
        super().__init__()
        self.project_in = Linear(fused, dim, True)
        self.project_out = Linear(dim, fused, True)


class _Backbone(nn.Module):
    def __init__(self, cfg: XCodec2ModelConfig):
        super().__init__()
        A = cfg.acoustic_dim
        self.embed = Conv1d(A, A, 7)
        self.norm_in = Norm(A, "layernorm")
        self.roformer = Roformer(cfg.backbone())
        self.norm_out = Norm(A, "layernorm")


class XCodec2(Codec):
    """X-Codec 2.0 with the standardized ``[B,T]`` ↔ ``[B,N,1]`` contract.

    ``sig_to_feats`` is the fused pre-quantizer embedding ``[B, N, 2048]``;
    ``feats_to_sig`` decodes it without re-quantizing, as the reference
    does. ``state_dict`` is loaded strictly; without it the weights are
    drawn by :func:`init_xcodec2_params` from ``generator`` (seed 0 by
    default). Encode mode drops the decoder (``backbone``, ``head``,
    ``fc_post_a``), decode mode both encoders, ``fc_prior`` and
    ``fc_post_s``. ``device=None`` means the card."""

    DEFAULT_ORIG_SR = 16000
    # the reference keeps the encoder's snake α as [1, 1, C]
    JAX_ALPHA_SHAPE = (1, 1, -1)

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return XCodec2ModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        model_config: Optional[XCodec2ModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        if num_codebooks != 1:
            raise ValueError("XCodec2 is single-codebook (K=1)")
        mc = model_config or XCodec2ModelConfig(sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.vocab_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        self._dec_form = form.ignoring_dtype()
        A, S, F_ = mc.acoustic_dim, mc.semantic_dim, mc.fused_dim
        if mode != "decode":
            self.encoder = CodecEncoder(mc.encoder())
            self.w2vbert = W2VBert(mc.w2vbert)
            self.semantic_encoder = _SemanticEncoder(
                mc.w2vbert.hidden_size, S)
            self.fc_prior = Linear(S + A, F_, True)
            self.fc_post_s = Linear(F_, S, True)
        if mode != "encode":
            self.fc_post_a = Linear(F_, A, True)
            self.backbone = _Backbone(mc)
            self.head = Linear(A, mc.n_fft + 2, True)
        self.quantizer = _Quantizer(F_, len(mc.levels))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_xcodec2_params(generator, mc)
        drop = {"encode": ("backbone.", "head.", "fc_post_a."),
                "decode": ("encoder.", "w2vbert.", "semantic_encoder.",
                           "fc_prior.", "fc_post_s.")}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _latents(self, sig):
        """Both branches fused → the pre-quantizer embedding
        ``[B, N, fused_dim]`` (the vendor's ``encode_feats``)."""
        mc = self.model_config
        ac = self.encoder(sig[:, None, :]).transpose(1, 2)
        feats = w2vbert_features(F.pad(sig, (160, 160)), mc.sampling_rate)
        sem = apply_w2vbert(self.w2vbert, feats, mc.w2vbert,
                            output_layer=mc.semantic_layer)
        sem = self.semantic_encoder(sem)
        N = min(ac.shape[1], sem.shape[1])
        return _linear(torch.cat([sem[:, :N], ac[:, :N]], dim=-1),
                       self.fc_prior)

    def _quantize(self, z):
        levels = self.model_config.levels
        codes = fsq_quantize(_linear(z, self.quantizer.project_in), levels)
        return fsq_codes_to_indices(codes, levels)

    def _decode(self, q):
        """Post-quantizer embedding ``[B, N, fused_dim]`` → ``[B, N·hop]``."""
        mc, bb, f = self.model_config, self.backbone, self._dec_form
        h = _linear(q, self.fc_post_a).transpose(1, 2)
        h = f.conv1d(h, bb.embed, pad=(bb.embed.w.shape[-1] - 1) // 2)
        h = _ln(h.transpose(1, 2), bb.norm_in)
        h = _ln(apply_roformer(bb.roformer, h, mc.backbone(), f), bb.norm_out)
        y = _linear(h, self.head)
        half = mc.n_fft // 2 + 1
        mag = torch.exp(torch.clamp(y[..., :half], max=100.0))
        phase = y[..., half:]
        return istft(mag * torch.cos(phase), mag * torch.sin(phase),
                     mc.n_fft, mc.hop_length, padding="same")

    def _sig_to_feats(self, sig, length):
        del length
        return self._latents(sig)

    def _sig_to_toks(self, sig, length):
        del length
        return self._quantize(self._latents(sig))[..., None]

    def _toks_to_qfeats(self, toks, length):
        codes = fsq_indices_to_codes(toks[..., 0], self.model_config.levels)
        return _linear(codes, self.quantizer.project_out)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _toks_to_sig(self, toks, length):
        return self._decode(self._toks_to_qfeats(toks, length))

    def _feats_to_sig(self, feats, length):
        # the vendor decodes features directly, without re-quantizing
        return self._decode(feats)

    def embs(self) -> torch.Tensor:
        """The FSQ lattice ``[1, 65536, 8]``."""
        cb = fsq_implicit_codebook(self.model_config.levels)
        return torch.from_numpy(cb).to(self.device)[None]


def init_xcodec2_params(generator: torch.Generator,
                        cfg: XCodec2ModelConfig) -> dict:
    """Random weights of :class:`XCodec2` as a flat state dict: the encoder
    in :func:`..models.bigcodec.init_codec_encoder_params`'s distributions,
    the rest in the reference's (linears and convs N(0, 1) · fan_in^-½,
    zero biases, unit norm gains); the draws differ from ``jax.random``'s."""
    A, S, F_ = cfg.acoustic_dim, cfg.semantic_dim, cfg.fused_dim
    D, W = len(cfg.levels), cfg.w2vbert.hidden_size
    out = init_codec_encoder_params(generator, cfg.encoder())
    out.update(init_w2vbert_params(generator, cfg.w2vbert, "w2vbert."))

    def randn(*shape, fan):
        return torch.randn(shape, generator=generator) * fan ** -0.5

    def lin(name, i, o):
        out[f"{name}.w"] = randn(i, o, fan=i)
        out[f"{name}.b"] = torch.zeros(o)

    init_conv(out, generator, "semantic_encoder.init", W, S, 3)
    for name in ("res1", "res2", "final"):
        init_conv(out, generator, f"semantic_encoder.{name}", S, S, 3)
    lin("fc_prior", S + A, F_)
    lin("fc_post_a", F_, A)
    lin("fc_post_s", F_, S)
    lin("quantizer.project_in", F_, D)
    lin("quantizer.project_out", D, F_)
    init_conv(out, generator, "backbone.embed", A, A, 7)
    for name in ("norm_in", "norm_out"):
        out[f"backbone.{name}.g"] = torch.ones(A)
        out[f"backbone.{name}.b"] = torch.zeros(A)
    out.update(init_roformer_params(generator, cfg.backbone(),
                                    "backbone.roformer."))
    lin("head", A, cfg.n_fft + 2)
    return out
