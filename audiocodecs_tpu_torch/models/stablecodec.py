"""Stable Codec (a transformer autoencoder with residual FSQ), PyTorch.

Counterpart of ``audiocodecs_tpu/models/stablecodec.py``
(``stabilityai/stable-codec-speech-16k``), weight-compatible with its param
tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`. The
waveform, padded to a whole number of 640-sample windows, is patchified by
a stride-320 conv (16 kHz → 50 Hz, dim 1024), run through the outer
RoFormer (8 blocks), pooled 2× by a linear over frame pairs (→ 25 Hz), run
through the inner RoFormer (8 blocks), normed and projected to a 6-d
latent. The towers are stable-audio-tools': gateless attention and SwiGLU
feed-forwards (:mod:`..nn.roformer`). The quantizer is the reference's
post-hoc residual FSQ ladder: each stage rounds the residual divided by
its fixed scale on a 6-d lattice, (2, 15625) by default (levels (5,)×6,
scales (1, 0.25)). The decoder mirrors the encoder and unpatchifies with a
stride-320 transposed conv.

The encoder and the quantizer run in exact fp32 (TF32 off).
``decode_dtype`` and ``decode_precision`` (a serving tier's arguments) set
the decoder's :class:`..nn.layers.DecodeForm` as the reference's switches
do, where its decoder runs inside ``conv_role("decoder")``: fp32
activations at ``decode_precision="default"`` (its
``ACX_DEC_CONV_PRECISION=default``) run both decoder towers' RoFormer
products and the unpatchifying transposed conv (the linears ``from_latent``
and ``dec_up`` stay exact, as the reference gives them no precision) on
bf16-rounded operands with fp32 sums, one bf16 pass. The reference's
StableCodec reads no activation dtype, so bf16 activations (the
EnCodec-style tier, which sets no decoder precision) decode exactly, as at
the default. The reference's bf16 activations together with
``ACX_DEC_CONV_PRECISION=default`` have no name among the port's arguments,
and no preset reaches them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    DecodeForm,
    conv1d,
)
from audiocodecs_tpu_torch.nn.roformer import (
    Roformer,
    RoformerConfig,
    apply_roformer,
    init_roformer_params,
)
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, _linear, _norm
from audiocodecs_tpu_torch.quant.fsq import (
    fsq_codes_to_indices,
    fsq_implicit_codebook,
    fsq_indices_to_codes,
    fsq_quantize,
)

__all__ = ["StableCodec", "StableCodecModelConfig", "init_stablecodec_params"]

# (levels a stage, each stage's residual scale) of the published post-hoc
# bottlenecks, by (stages, codes a stage)
_BOTTLENECKS = {
    (1, 46656): ((6,) * 6, (1.0,)),
    (2, 15625): ((5,) * 6, (1.0, 0.25)),
    (4, 729): ((3,) * 6, (1.0, 0.5, 0.25, 0.125)),
}


@dataclasses.dataclass(frozen=True)
class StableCodecModelConfig:
    sampling_rate: int = 16000
    patch: int = 320  # patchify hop → 50 Hz before the pool
    dim: int = 1024
    depth_outer: int = 8  # blocks at 50 Hz
    depth_inner: int = 8  # blocks at 25 Hz
    num_heads: int = 16
    latent_dim: int = 6
    levels: tuple[int, ...] = (5,) * 6
    scales: tuple[float, ...] = (1.0, 0.25)

    @property
    def hop_length(self) -> int:
        return self.patch * 2

    @property
    def vocab_size(self) -> int:
        return math.prod(self.levels)

    def roformer(self, depth: int) -> RoformerConfig:
        return RoformerConfig(dim=self.dim, depth=depth,
                              num_heads=self.num_heads,
                              rope_dim=min(64, self.dim // self.num_heads),
                              use_gates=False, ffn="swiglu")


def _ln(x, p: Norm):
    return _norm(x, p, "layernorm", 1e-6)


class StableCodec(Codec):
    """StableCodec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract
    (K ≤ the ladder's stages; 25 Hz frames).

    ``sig_to_feats`` is the continuous 6-d latent before the bottleneck.
    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_stablecodec_params` from ``generator`` (seed 0 by default).
    Encode mode drops the decoder's entries (``dec_*``, ``from_latent``,
    ``unpatch``), decode mode the encoder's (``enc_*``, ``patch``,
    ``to_latent``). ``device=None`` means the card."""

    DEFAULT_ORIG_SR = 16000

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None,
                             bottleneck: tuple[int, int] = (2, 15625)):
        """``bottleneck`` = (stages, codes a stage): (1, 46656), (2, 15625)
        or (4, 729)."""
        if bottleneck not in _BOTTLENECKS:
            raise ValueError(f"unsupported bottleneck {bottleneck}; "
                             f"choose from {sorted(_BOTTLENECKS)}")
        levels, scales = _BOTTLENECKS[bottleneck]
        return StableCodecModelConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR,
            levels=levels, scales=scales)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: Optional[int] = None,
        model_config: Optional[StableCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        orig_sample_rate = orig_sample_rate or self.DEFAULT_ORIG_SR
        mc = model_config or self.default_model_config(orig_sample_rate)
        num_codebooks = num_codebooks or len(mc.scales)
        if num_codebooks > len(mc.scales):
            raise ValueError(f"num_codebooks {num_codebooks} > bottleneck "
                             f"stages {len(mc.scales)}")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.vocab_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        self._dec_form = form.ignoring_dtype()
        C, D = mc.dim, mc.latent_dim
        if mode != "decode":
            self.patch = Conv1d(1, C, mc.patch)
            self.enc_outer = Roformer(mc.roformer(mc.depth_outer))
            self.enc_down = Linear(2 * C, C, True)
            self.enc_inner = Roformer(mc.roformer(mc.depth_inner))
            self.enc_norm = Norm(C, "layernorm")
            self.to_latent = Linear(C, D, True)
        if mode != "encode":
            self.from_latent = Linear(D, C, True)
            self.dec_inner = Roformer(mc.roformer(mc.depth_inner))
            self.dec_up = Linear(C, 2 * C, True)
            self.dec_outer = Roformer(mc.roformer(mc.depth_outer))
            self.dec_norm = Norm(C, "layernorm")
            self.unpatch = ConvTranspose1d(C, 1, mc.patch)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_stablecodec_params(generator, mc)
        drop = {"encode": ("dec_", "from_latent.", "unpatch."),
                "decode": ("enc_", "patch.", "to_latent.")}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _latents(self, sig):
        """``[B, T]`` → the continuous latents ``[B, N, latent_dim]``."""
        mc = self.model_config
        pad = (-sig.shape[-1]) % mc.hop_length
        if pad:
            sig = F.pad(sig, (0, pad))
        x = conv1d(sig[:, None, :], self.patch.w, self.patch.b,
                   stride=mc.patch).transpose(1, 2)  # [B, T/p, dim]
        x = apply_roformer(self.enc_outer, x, mc.roformer(mc.depth_outer))
        B, N, C = x.shape
        x = _linear(x.reshape(B, N // 2, 2 * C), self.enc_down)  # → 25 Hz
        x = apply_roformer(self.enc_inner, x, mc.roformer(mc.depth_inner))
        return _linear(_ln(x, self.enc_norm), self.to_latent)

    def _residual_encode(self, z, K: int):
        mc = self.model_config
        toks, residual = [], z
        for s in mc.scales[:K]:
            codes = fsq_quantize(residual / s, mc.levels)
            toks.append(fsq_codes_to_indices(codes, mc.levels))
            residual = residual - codes * s
        return torch.stack(toks, dim=-1)

    def _decode(self, z):
        mc, f = self.model_config, self._dec_form
        x = _linear(z, self.from_latent)
        x = apply_roformer(self.dec_inner, x, mc.roformer(mc.depth_inner), f)
        B, N, C = x.shape
        x = _linear(x, self.dec_up).reshape(B, N * 2, C)
        x = apply_roformer(self.dec_outer, x, mc.roformer(mc.depth_outer), f)
        x = _ln(x, self.dec_norm).transpose(1, 2)
        y = f.conv_transpose1d(x, self.unpatch, stride=mc.patch)
        return y[:, 0]

    def _sig_to_feats(self, sig, length):
        del length
        return self._latents(sig)

    def _sig_to_toks(self, sig, length):
        del length
        return self._residual_encode(self._latents(sig),
                                     self.config.num_codebooks)

    def _toks_to_qfeats(self, toks, length):
        mc = self.model_config
        acc = None
        for k in range(toks.shape[-1]):
            c = fsq_indices_to_codes(toks[..., k], mc.levels) * mc.scales[k]
            acc = c if acc is None else acc + c
        return acc

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _toks_to_sig(self, toks, length):
        return self._decode(self._toks_to_qfeats(toks, length))

    def _feats_to_sig(self, feats, length):
        return self._decode(feats)

    def embs(self) -> torch.Tensor:
        """The scaled lattices ``[K, C, latent_dim]``, one a stage."""
        mc = self.model_config
        cb = torch.from_numpy(fsq_implicit_codebook(mc.levels)).to(
            self.device)
        return torch.stack([cb * mc.scales[k]
                            for k in range(self.config.num_codebooks)])


def init_stablecodec_params(generator: torch.Generator,
                            cfg: StableCodecModelConfig) -> dict:
    """Random weights of :class:`StableCodec` as a flat state dict, in the
    reference's distributions (linears N(0, 1/in), the patch convs
    N(0, 1/patch) and N(0, 1/dim), zero biases, unit norm gains); the draws
    differ from ``jax.random``'s."""
    C, D = cfg.dim, cfg.latent_dim
    out = {}

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=generator) * i ** -.5
        out[f"{name}.b"] = torch.zeros(o)

    def norm(name):
        out[f"{name}.g"] = torch.ones(C)
        out[f"{name}.b"] = torch.zeros(C)

    def tower(name, depth):
        out.update(init_roformer_params(generator, cfg.roformer(depth),
                                        f"{name}."))

    out["patch.w"] = (torch.randn((C, 1, cfg.patch), generator=generator)
                      * cfg.patch ** -0.5)
    out["patch.b"] = torch.zeros(C)
    tower("enc_outer", cfg.depth_outer)
    lin("enc_down", 2 * C, C)
    tower("enc_inner", cfg.depth_inner)
    norm("enc_norm")
    lin("to_latent", C, D)
    lin("from_latent", D, C)
    tower("dec_inner", cfg.depth_inner)
    lin("dec_up", C, 2 * C)
    tower("dec_outer", cfg.depth_outer)
    norm("dec_norm")
    out["unpatch.w"] = (torch.randn((C, 1, cfg.patch), generator=generator)
                        * C ** -0.5)
    out["unpatch.b"] = torch.zeros(1)
    return out
