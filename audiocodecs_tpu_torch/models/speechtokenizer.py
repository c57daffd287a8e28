"""SpeechTokenizer, PyTorch.

Counterpart of ``audiocodecs_tpu/models/speechtokenizer.py``: an
EnCodec-style SEANet with non-causal, reflect-padded convs, a 2-layer
**bidirectional** encoder LSTM (output 2·C, added to the input duplicated
over channels), a plain 2-layer decoder LSTM and an 8-stage RVQ whose first
codebook is semantically distilled; 16 kHz, hop 320. The published release
(``speechtokenizer_hubert_avg``) has 64 filters, ratios (8, 5, 4, 2), latent
1024 and 8 × 1024 × 1024 codebooks, so every LSTM is 1024 wide.

On the card each LSTM direction of each layer is one launch of the
recurrence kernel (:mod:`..ops.lstm_recurrence`): 4 for the encoder's
BiLSTM and 2 for the decoder's LSTM a roundtrip. The residual blocks are
non-causal, which the fused block kernel does not take, so they run cuDNN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import (
    Codec,
    CodecConfig,
    prune_params_for_mode,
)
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    init_seanet_params,
    seanet_decoder_plan,
    seanet_encoder_plan,
    stack_forms,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["SpeechTokenizer", "SpeechTokenizerModelConfig",
           "init_speechtokenizer_params"]


@dataclasses.dataclass(frozen=True)
class SpeechTokenizerModelConfig:
    sampling_rate: int = 16000
    audio_channels: int = 1
    num_filters: int = 64
    hidden_size: int = 1024  # latent ("dimension")
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    use_causal_conv: bool = False
    pad_mode: str = "reflect"
    codebook_size: int = 1024
    codebook_dim: int = 1024
    num_quantizers: int = 8

    def seanet(self, bidirectional: bool) -> SEANetConfig:
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
            use_conv_shortcut=True,
            lstm_bidirectional=bidirectional,
        )


class SpeechTokenizer(Codec):
    """SpeechTokenizer with the standardized ``[B,T]`` ↔ ``[B,N,K]``
    contract. ``state_dict`` is loaded strictly; without it the weights are
    drawn by :func:`init_speechtokenizer_params` from ``generator`` (seed 0
    by default). ``device=None`` means the card.

    ``decode_dtype`` and ``decode_precision`` set the decoder stack's form
    (:class:`..nn.layers.DecodeForm`: the reference's serving tiers, which
    :mod:`audiocodecs_tpu_torch.serving` picks by family) and
    ``encode_precision`` the encoder stack's (:func:`..nn.seanet.
    stack_forms`). The quantizer and the LSTMs stay exact fp32 in every
    form, as the reference fixes them at HIGHEST.
    """

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return SpeechTokenizerModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        model_config: Optional[SpeechTokenizerModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        encode_precision: str = "exact",
    ):
        mc = model_config or SpeechTokenizerModelConfig(
            sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.encode_form, self.decode_form = stack_forms(
            decode_dtype, decode_precision, encode_precision)
        if mode != "decode":
            enc = mc.seanet(True)
            self.encoder = SEANet(enc, seanet_encoder_plan(enc),
                                  self.encode_form)
        if mode != "encode":
            dec = mc.seanet(False)
            self.decoder = SEANet(dec, seanet_decoder_plan(dec),
                                  self.decode_form)
        self.codebooks = nn.Parameter(torch.empty(
            mc.num_quantizers, mc.codebook_size, mc.codebook_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_speechtokenizer_params(generator, mc)
        self.load_state_dict(prune_params_for_mode(state_dict, mode),
                             strict=True)
        self.to(self.device)
        self.eval()

    def _sig_to_feats(self, sig, length):
        del length
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_toks(self, sig, length):
        return rvq_encode(self._sig_to_feats(sig, length), self.codebooks,
                          self.config.num_codebooks)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(rvq_decode(toks, self.codebooks), length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))[:, 0]

    def embs(self) -> torch.Tensor:
        """``[K, C, H]`` RVQ codebooks of the used stages."""
        return self.codebooks[: self.config.num_codebooks]


def init_speechtokenizer_params(generator: torch.Generator,
                                cfg: SpeechTokenizerModelConfig) -> dict:
    """Random weights as a flat state dict (the reference package's
    distributions, drawn from ``generator``)."""
    out = {}
    for name, sea, plan_of in (("encoder", cfg.seanet(True),
                                seanet_encoder_plan),
                               ("decoder", cfg.seanet(False),
                                seanet_decoder_plan)):
        for k, v in init_seanet_params(generator, sea, plan_of(sea)).items():
            out[f"{name}.{k}"] = v
    out["codebooks"] = torch.randn(
        (cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim),
        generator=generator)
    return out
