"""WavTokenizer, PyTorch.

Counterpart of ``audiocodecs_tpu/models/wavtokenizer.py``: a
single-codebook codec (``novateur/WavTokenizer``, 24 kHz, hop 320, 75 Hz).
An EnCodec-style causal SEANet encoder (32 filters, LSTMs at H = 512,
hidden 512) → one 4096 × 512 VQ → a Vocos head with plain LayerNorm (dim
768, 12 ConvNeXt blocks, n_fft 1280). On the card the encoder's LSTMs and
causal residual blocks run the package's CUDA kernels; the Vocos head is
library calls (:mod:`..nn.vocos`).

The head's ISTFT uses ``padding="center"``, as the reference's decode
calls it, so a decode of N frames is ``(N − 1)·hop`` samples long.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    init_seanet_params,
    seanet_encoder_plan,
    stack_forms,
)
from audiocodecs_tpu_torch.nn.vocos import (
    Vocos,
    VocosConfig,
    apply_vocos,
    init_vocos_params,
)
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["WavTokenizer", "WavTokenizerModelConfig",
           "init_wavtokenizer_params"]


@dataclasses.dataclass(frozen=True)
class WavTokenizerModelConfig:
    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 512
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)  # hop 320 → 75 Hz
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    codebook_size: int = 4096
    codebook_dim: int = 512
    # Vocos head
    vocos_dim: int = 768
    vocos_intermediate_dim: int = 2304
    vocos_layers: int = 12
    n_fft: int = 1280
    hop_length: int = 320

    def seanet(self) -> SEANetConfig:
        return SEANetConfig(
            audio_channels=self.audio_channels,
            num_filters=self.num_filters,
            hidden_size=self.hidden_size,
            ratios=self.upsampling_ratios,
            kernel_size=self.kernel_size,
            last_kernel_size=self.last_kernel_size,
            residual_kernel_size=self.residual_kernel_size,
            dilation_growth_rate=self.dilation_growth_rate,
            num_residual_layers=self.num_residual_layers,
            compress=self.compress,
            num_lstm_layers=self.num_lstm_layers,
            causal=self.use_causal_conv,
            pad_mode=self.pad_mode,
        )

    def vocos(self) -> VocosConfig:
        return VocosConfig(
            input_channels=self.codebook_dim,
            dim=self.vocos_dim,
            intermediate_dim=self.vocos_intermediate_dim,
            num_layers=self.vocos_layers,
            n_fft=self.n_fft,
            hop_length=self.hop_length,
            num_adanorm_embeddings=None,
        )


class WavTokenizer(Codec):
    """WavTokenizer with the standardized ``[B,T]`` ↔ ``[B,N,1]`` contract.

    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_wavtokenizer_params` from ``generator`` (seed 0 by
    default). Encode mode drops the head, decode mode the encoder.
    ``device=None`` means the card.

    ``decode_dtype`` and ``decode_precision`` are taken, and checked, as
    the other SEANet families take them, but change nothing: the decoder is
    the Vocos head, and the reference's Vocos reads no activation dtype, so
    its serving tier decodes as its exact one. ``encode_precision`` sets
    the encoder stack's form (:func:`..nn.seanet.stack_forms`).
    """

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 24000):
        return WavTokenizerModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 24000,
        mode: str = "reconstruct",
        num_codebooks: int = 1,
        model_config: Optional[WavTokenizerModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        encode_precision: str = "exact",
    ):
        if num_codebooks != 1:
            raise ValueError("WavTokenizer is single-codebook (K=1)")
        mc = model_config or WavTokenizerModelConfig(
            sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=1, vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.encode_form, self.decode_form = stack_forms(
            decode_dtype, decode_precision, encode_precision)
        if mode != "decode":
            sea = mc.seanet()
            self.encoder = SEANet(sea, seanet_encoder_plan(sea),
                                  self.encode_form)
        if mode != "encode":
            self.vocos = Vocos(mc.vocos())
        self.codebook = nn.Parameter(torch.empty(mc.codebook_size,
                                                 mc.codebook_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_wavtokenizer_params(generator, mc)
        drop = {"encode": ("vocos.",), "decode": ("encoder.",)}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _sig_to_feats(self, sig, length):
        del length
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_toks(self, sig, length):
        return vq_encode(self._sig_to_feats(sig, length),
                         self.codebook)[..., None]

    def _sig_to_qfeats(self, sig, length):
        return vq_decode(self._sig_to_toks(sig, length)[..., 0],
                         self.codebook)

    def _toks_to_qfeats(self, toks, length):
        return vq_decode(toks[..., 0], self.codebook)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(vq_decode(toks[..., 0], self.codebook),
                                  length)

    def _feats_to_sig(self, feats, length):
        return apply_vocos(self.vocos, feats, self.model_config.vocos())

    def embs(self) -> torch.Tensor:
        return self.codebook[None]  # [1, C, H]


def init_wavtokenizer_params(generator: torch.Generator,
                             cfg: WavTokenizerModelConfig) -> dict:
    """Random weights as a flat state dict, in the reference package's
    distributions (the draws differ from ``jax.random``'s)."""
    sea = cfg.seanet()
    out = {f"encoder.{k}": v for k, v in init_seanet_params(
        generator, sea, seanet_encoder_plan(sea)).items()}
    out["codebook"] = torch.randn((cfg.codebook_size, cfg.codebook_dim),
                                  generator=generator)
    out.update({f"vocos.{k}": v for k, v in init_vocos_params(
        generator, cfg.vocos()).items()})
    return out
