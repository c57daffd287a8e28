"""MagiCodec (a transformer codec with one 131,072-entry VQ), PyTorch.

Counterpart of ``audiocodecs_tpu/models/magicodec.py``
(``MagiCodec-50Hz-Base``), weight-compatible with its param tree through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. A conv patchify
(k 640, stride 320, zero pad 160 a side: 16 kHz → 50 Hz, dim 1024) → an
8-block RoFormer encoder (gated, GELU) → LayerNorm → ``in_proj`` to 16
dims → one nearest-neighbour VQ over a 131,072 × 16 codebook, on
unit-normed vectors (``l2_normalized``; the search is one
``[B·N, 16] @ [16, 131072]`` product and an argmax, :mod:`..quant.vq`) →
``out_proj`` back to 1024 → an 8-block RoFormer decoder → LayerNorm → a
stride-320 transposed conv, trimmed by 160 a side.

The encoder and the quantizer run in exact fp32 (TF32 off), the codebook
distances included. ``decode_dtype`` and ``decode_precision`` (a serving
tier's arguments) set the decoder's :class:`..nn.layers.DecodeForm` as the
reference's switches do, where its decoder runs inside
``conv_role("decoder")``: fp32 activations at
``decode_precision="default"`` (its ``ACX_DEC_CONV_PRECISION=default``) run
the decoder's RoFormer products and its transposed conv on bf16-rounded
operands with fp32 sums, one bf16 pass. The reference's MagiCodec reads no
activation dtype, so bf16 activations (the EnCodec-style tier, which sets
no decoder precision) decode exactly, as at the default. The reference's
bf16 activations together with ``ACX_DEC_CONV_PRECISION=default`` have no
name among the port's arguments, and no preset reaches them.
"""

from __future__ import annotations

import dataclasses
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
    unit_norm,
)
from audiocodecs_tpu_torch.nn.roformer import (
    Roformer,
    RoformerConfig,
    apply_roformer,
    init_roformer_params,
)
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, _linear, _norm
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["MagiCodec", "MagiCodecModelConfig", "init_magicodec_params"]


@dataclasses.dataclass(frozen=True)
class MagiCodecModelConfig:
    sampling_rate: int = 16000
    hop_length: int = 320  # 50 Hz tokens
    dim: int = 1024
    depth: int = 8  # transformer blocks a side
    num_heads: int = 16
    codebook_size: int = 131072
    codebook_dim: int = 16
    l2_normalized: bool = True

    def roformer(self) -> RoformerConfig:
        return RoformerConfig(dim=self.dim, depth=self.depth,
                              num_heads=self.num_heads,
                              rope_dim=min(64, self.dim // self.num_heads))


def _ln(x, p: Norm):
    return _norm(x, p, "layernorm", 1e-6)


class MagiCodec(Codec):
    """MagiCodec with the standardized ``[B,T]`` ↔ ``[B,N,1]`` contract.

    ``latent`` makes ``embs()`` the raw 16-d codebook rows; by default it is
    their ``out_proj`` image. ``state_dict`` is loaded strictly; without it
    the weights are drawn by :func:`init_magicodec_params` from
    ``generator`` (seed 0 by default). Encode mode drops ``dec``,
    ``dec_norm``, ``unpatch`` and ``out_proj``; decode mode ``enc``,
    ``enc_norm``, ``patch`` and ``in_proj``. ``device=None`` means the
    card."""

    DEFAULT_ORIG_SR = 16000

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None):
        return MagiCodecModelConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        latent: bool = False,
        model_config: Optional[MagiCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        if num_codebooks != 1:
            raise ValueError("MagiCodec is single-codebook (K=1)")
        orig_sample_rate = orig_sample_rate or self.DEFAULT_ORIG_SR
        mc = model_config or self.default_model_config(orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.latent = latent
        self.decode_form = form
        self._dec_form = form.ignoring_dtype()
        C, D, k = mc.dim, mc.codebook_dim, 2 * mc.hop_length
        if mode != "decode":
            self.patch = Conv1d(1, C, k)
            self.enc = Roformer(mc.roformer())
            self.enc_norm = Norm(C, "layernorm")
            self.in_proj = Linear(C, D, True)
        self.codebook = nn.Parameter(torch.empty(mc.codebook_size, D))
        if mode != "encode":
            self.out_proj = Linear(D, C, True)
            self.dec = Roformer(mc.roformer())
            self.dec_norm = Norm(C, "layernorm")
            self.unpatch = ConvTranspose1d(C, 1, k)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_magicodec_params(generator, mc)
        drop = {"encode": ("dec.", "dec_norm.", "unpatch.", "out_proj."),
                "decode": ("enc.", "enc_norm.", "patch.", "in_proj.")}.get(
                    mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _latents(self, sig):
        mc = self.model_config
        pad = mc.hop_length // 2  # (k − hop) / 2 with k = 2·hop
        x = conv1d(F.pad(sig[:, None, :], (pad, pad)), self.patch.w,
                   self.patch.b, stride=mc.hop_length).transpose(1, 2)
        x = _ln(apply_roformer(self.enc, x, mc.roformer()), self.enc_norm)
        return _linear(x, self.in_proj)  # [B, N, codebook_dim]

    def _dequantize(self, idx):
        return _linear(vq_decode(idx, self.codebook), self.out_proj)

    def _decode(self, h):
        mc = self.model_config
        f = self._dec_form
        x = _ln(apply_roformer(self.dec, h, mc.roformer(), f), self.dec_norm)
        y = f.conv_transpose1d(x.transpose(1, 2), self.unpatch,
                               stride=mc.hop_length)
        pad = mc.hop_length // 2
        return y[:, 0, pad: y.shape[-1] - pad]

    def _quantize(self, z):
        """Latents ``[B, N, codebook_dim]`` → indices ``[B, N]``."""
        if self.model_config.l2_normalized:
            return vq_encode(unit_norm(z), unit_norm(self.codebook))
        return vq_encode(z, self.codebook)

    def _sig_to_feats(self, sig, length):
        del length
        return self._latents(sig)

    def _sig_to_toks(self, sig, length):
        del length
        return self._quantize(self._latents(sig))[..., None]

    def _sig_to_qfeats(self, sig, length):
        return self._dequantize(self._sig_to_toks(sig, length)[..., 0])

    def _toks_to_qfeats(self, toks, length):
        return self._dequantize(toks[..., 0])

    def _toks_to_sig(self, toks, length):
        return self._decode(self._dequantize(toks[..., 0]))

    def _feats_to_sig(self, feats, length):
        return self._decode(feats)

    def embs(self) -> torch.Tensor:
        """``[1, C, dim]``: the codebook's ``out_proj`` image, or with
        ``latent`` the raw rows ``[1, C, codebook_dim]``."""
        with torch.inference_mode():
            if self.latent:
                return self.codebook.detach()[None]
            return _linear(self.codebook, self.out_proj)[None]


def init_magicodec_params(generator: torch.Generator,
                          cfg: MagiCodecModelConfig) -> dict:
    """Random weights of :class:`MagiCodec` as a flat state dict, in the
    reference's distributions (linears N(0, 1/in), the patch convs
    N(0, 1/640) and N(0, 1/dim), the codebook N(0, 1), zero biases, unit
    norm gains); the draws differ from ``jax.random``'s."""
    C, D, k = cfg.dim, cfg.codebook_dim, 2 * cfg.hop_length
    out = {}

    def lin(name, i, o):
        out[f"{name}.w"] = torch.randn((i, o), generator=generator) * i ** -.5
        out[f"{name}.b"] = torch.zeros(o)

    out["patch.w"] = torch.randn((C, 1, k), generator=generator) * k ** -0.5
    out["patch.b"] = torch.zeros(C)
    out.update(init_roformer_params(generator, cfg.roformer(), "enc."))
    out["enc_norm.g"], out["enc_norm.b"] = torch.ones(C), torch.zeros(C)
    lin("in_proj", C, D)
    out["codebook"] = torch.randn((cfg.codebook_size, D), generator=generator)
    lin("out_proj", D, C)
    out.update(init_roformer_params(generator, cfg.roformer(), "dec."))
    out["dec_norm.g"], out["dec_norm.b"] = torch.ones(C), torch.zeros(C)
    out["unpatch.w"] = torch.randn((C, 1, k), generator=generator) * C ** -0.5
    out["unpatch.b"] = torch.zeros(1)
    return out
