"""FocalCodec (a one-codebook binary spherical codec), PyTorch.

Counterpart of ``audiocodecs_tpu/models/focalcodec.py`` (arXiv:2502.04465),
weight-compatible with its param tree through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. Encode: 6 layers of
WavLM-large, the 6th layer's state un-normed (``final_ln_tap=False``: the
interior state of the 24-layer model) → a 2-block focal-modulation
compressor (:mod:`..nn.focalnet`) → ``down_proj`` to 13 dims → binary
spherical quantization: on the unit sphere, one sign bit a dim, so a token
of 13 bits (8192 codes). Decode: the bits to the lattice point ±1/√13 a
dim → ``up_proj`` → the focal decompressor → a Vocos head (512 wide, 8
ConvNeXt blocks, plain LayerNorm, ISTFT with n_fft 1280 and hop 320,
``padding="center"``).

Everything runs in exact fp32 (TF32 off). ``decode_dtype`` and
``decode_precision`` (a serving tier's arguments) are taken and checked
but change nothing: the reference's FocalCodec reads no activation dtype
and opens no decoder scope, so it decodes exactly in every tier.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.focalnet import (
    FocalBlocks,
    FocalConfig,
    apply_focal_blocks,
    init_focal_params,
)
from audiocodecs_tpu_torch.nn.layers import DecodeForm, unit_norm
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear
from audiocodecs_tpu_torch.nn.vocos import (
    Vocos,
    VocosConfig,
    apply_vocos,
    init_vocos_params,
)
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
    wavlm_large_config,
)

__all__ = ["FocalCodec", "FocalCodecModelConfig", "bsq_decode", "bsq_encode",
           "init_focalcodec_params"]


def _focal_wavlm_config() -> WavLMConfig:
    """WavLM-large's shape cut to the 6 layers FocalCodec keeps."""
    return dataclasses.replace(wavlm_large_config(), num_layers=6)


@dataclasses.dataclass(frozen=True)
class FocalCodecModelConfig:
    sampling_rate: int = 16000
    codebook_bits: int = 13
    wavlm: WavLMConfig = dataclasses.field(default_factory=_focal_wavlm_config)
    wavlm_layer: int = 6
    compressor_blocks: int = 2
    vocos_dim: int = 512
    vocos_intermediate_dim: int = 1536
    vocos_layers: int = 8
    n_fft: int = 1280
    hop_length: int = 320

    @property
    def codebook_size(self) -> int:
        return 2 ** self.codebook_bits

    def compressor(self) -> FocalConfig:
        return FocalConfig(dim=self.wavlm.hidden_size,
                           num_blocks=self.compressor_blocks)

    def vocos(self) -> VocosConfig:
        return VocosConfig(
            input_channels=self.wavlm.hidden_size, dim=self.vocos_dim,
            intermediate_dim=self.vocos_intermediate_dim,
            num_layers=self.vocos_layers, n_fft=self.n_fft,
            hop_length=self.hop_length, num_adanorm_embeddings=None)


def bsq_encode(z: torch.Tensor) -> torch.Tensor:
    """``[..., D]`` → the sign bits of the unit-normed vector as an int64
    code ``[...]`` (bit d is dim d)."""
    bits = (unit_norm(z) > 0).long()
    weights = 2 ** torch.arange(z.shape[-1], device=z.device)
    return torch.sum(bits * weights, dim=-1)


def bsq_decode(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """Codes ``[...]`` → lattice points ``[..., dim]`` of ±1/√dim."""
    bits = (codes[..., None] >> torch.arange(dim, device=codes.device)) & 1
    return (2.0 * bits.float() - 1.0) / math.sqrt(dim)


class FocalCodec(Codec):
    """FocalCodec with the standardized ``[B,T]`` ↔ ``[B,N,1]`` contract
    (50 Hz frames at 16 kHz).

    ``sig_to_feats`` is the 13-d latent before quantization;
    ``feats_to_sig`` decodes its unit-normed form. ``state_dict`` is
    loaded strictly; without it the weights are drawn by
    :func:`init_focalcodec_params` from ``generator`` (seed 0 by default).
    Encode mode drops the decoder's entries (``decompressor``,
    ``up_proj``, ``decoder``), decode mode the encoder's (``encoder``,
    ``compressor``, ``down_proj``). ``device=None`` means the card."""

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return FocalCodecModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        model_config: Optional[FocalCodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        if num_codebooks != 1:
            raise ValueError("FocalCodec is single-codebook (K=1)")
        mc = model_config or FocalCodecModelConfig(
            sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.decode_form = form
        C, D = mc.wavlm.hidden_size, mc.codebook_bits
        if mode != "decode":
            self.encoder = WavLM(mc.wavlm)
            self.compressor = FocalBlocks(mc.compressor())
            self.down_proj = Linear(C, D, True)
        if mode != "encode":
            self.up_proj = Linear(D, C, True)
            self.decompressor = FocalBlocks(mc.compressor())
            self.decoder = Vocos(mc.vocos())
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_focalcodec_params(generator, mc)
        drop = {"encode": ("decompressor.", "up_proj.", "decoder."),
                "decode": ("encoder.", "compressor.", "down_proj.")}.get(
                    mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _latents(self, sig):
        """``[B, T]`` → the 13-d latents ``[B, N, bits]``."""
        mc = self.model_config
        feats = apply_wavlm(self.encoder, sig, mc.wavlm,
                            output_layer=mc.wavlm_layer, final_ln_tap=False)
        h = apply_focal_blocks(self.compressor, feats, mc.compressor())
        return _linear(h, self.down_proj)

    def _decode_latents(self, q):
        mc = self.model_config
        h = apply_focal_blocks(self.decompressor, _linear(q, self.up_proj),
                               mc.compressor())
        return apply_vocos(self.decoder, h, mc.vocos())

    def _sig_to_feats(self, sig, length):
        del length
        return self._latents(sig)

    def _sig_to_toks(self, sig, length):
        del length
        return bsq_encode(self._latents(sig))[..., None]

    def _toks_to_qfeats(self, toks, length):
        return bsq_decode(toks[..., 0], self.model_config.codebook_bits)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _toks_to_sig(self, toks, length):
        return self._decode_latents(self._toks_to_qfeats(toks, length))

    def _feats_to_sig(self, feats, length):
        return self._decode_latents(unit_norm(feats))

    def embs(self) -> torch.Tensor:
        """The binary spherical codebook ``[1, 2^bits, bits]``."""
        D = self.model_config.codebook_bits
        return bsq_decode(torch.arange(2 ** D, device=self.device), D)[None]


def init_focalcodec_params(generator: torch.Generator,
                           cfg: FocalCodecModelConfig) -> dict:
    """Random weights of :class:`FocalCodec` as a flat state dict, in the
    reference's distributions (the tower's :func:`..nn.wavlm.
    init_wavlm_params`, the focal blocks', the projections N(0, 1/in) with
    zero biases, the Vocos head's); the draws differ from the reference's."""
    C, D = cfg.wavlm.hidden_size, cfg.codebook_bits
    out = init_wavlm_params(generator, cfg.wavlm, "encoder.")
    out.update(init_focal_params(generator, cfg.compressor(), "compressor."))
    out["down_proj.w"] = torch.randn((C, D), generator=generator) * C ** -.5
    out["down_proj.b"] = torch.zeros(D)
    out["up_proj.w"] = torch.randn((D, C), generator=generator) * D ** -.5
    out["up_proj.b"] = torch.zeros(C)
    out.update(init_focal_params(generator, cfg.compressor(),
                                 "decompressor."))
    out.update({f"decoder.{k}": v for k, v in init_vocos_params(
        generator, cfg.vocos()).items()})
    return out
