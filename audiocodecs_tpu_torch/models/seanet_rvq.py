"""Generic SEANet encoder/decoder around a residual VQ, PyTorch.

Counterpart of ``audiocodecs_tpu/models/seanet_rvq.py``: the shared class
of the zoo families that are EnCodec's SEANet and RVQ at another rate, with
an optional 1×1 projector between encoder and quantizer when the codebook
width differs from the encoder's (``has_projector``). PAST
(:mod:`.past`) pins its defaults.

On the card the LSTMs and the causal residual blocks run the package's CUDA
kernels, as in EnCodec. Streaming is EnCodec's
(:class:`..models.encodec.SEANetStreaming`, with the projectors around the
quantizer): each conv a library call over the chunk and its carried left
context, each LSTM layer one recurrence kernel launch. It matches batch
mode exactly with ``pad_mode="constant"``; a reflect-padded config (PAST)
starts the stream from zero context instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.models.encodec import SEANetStreaming
from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    init_seanet_params,
    seanet_decoder_plan,
    seanet_encoder_plan,
    stack_forms,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["SEANetRVQConfig", "SEANetRVQCodec", "init_seanet_rvq_params"]


@dataclasses.dataclass(frozen=True)
class SEANetRVQConfig:
    sampling_rate: int = 16000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128  # encoder output dim
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    num_lstm_layers: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    use_conv_shortcut: bool = True
    codebook_size: int = 1024
    codebook_dim: int = 128  # may differ from hidden_size → projector convs
    num_quantizers: int = 8

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
            use_conv_shortcut=self.use_conv_shortcut,
        )

    @property
    def has_projector(self) -> bool:
        return self.codebook_dim != self.hidden_size


class SEANetRVQCodec(SEANetStreaming, Codec):
    """SEANet encoder → (projector) → RVQ → (unprojector) → SEANet decoder.

    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_seanet_rvq_params` from ``generator`` (seed 0 by default).
    Encode mode drops the decoder and ``out_proj``, decode mode the encoder
    and ``in_proj``. ``device=None`` means the card.

    ``decode_dtype`` and ``decode_precision`` set the decoder stack's form
    (:class:`..nn.layers.DecodeForm`: the reference's serving tiers, which
    :mod:`audiocodecs_tpu_torch.serving` picks by family) and
    ``encode_precision`` the encoder stack's (:func:`..nn.seanet.
    stack_forms`). The quantizer and the LSTMs stay exact fp32 in every
    form, as the reference fixes them at HIGHEST.
    """

    DEFAULT_ORIG_SR = 16000

    @classmethod
    def default_model_config(cls, orig_sample_rate: Optional[int] = None):
        return SEANetRVQConfig(
            sampling_rate=orig_sample_rate or cls.DEFAULT_ORIG_SR)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: Optional[int] = None,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        model_config: Optional[SEANetRVQConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        encode_precision: str = "exact",
    ):
        orig_sample_rate = orig_sample_rate or self.DEFAULT_ORIG_SR
        mc = model_config or self.default_model_config(orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        sea = mc.seanet()
        H, D = mc.hidden_size, mc.codebook_dim
        self.encode_form, self.decode_form = stack_forms(
            decode_dtype, decode_precision, encode_precision)
        if mode != "decode":
            self.encoder = SEANet(sea, seanet_encoder_plan(sea),
                                  self.encode_form)
            if mc.has_projector:
                self.in_proj = Conv1d(H, D, 1)
        if mode != "encode":
            self.decoder = SEANet(sea, seanet_decoder_plan(sea),
                                  self.decode_form)
            if mc.has_projector:
                self.out_proj = Conv1d(D, H, 1)
        self.codebooks = nn.Parameter(torch.empty(
            mc.num_quantizers, mc.codebook_size, D))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_seanet_rvq_params(generator, mc)
        drop = {"encode": ("decoder.", "out_proj."),
                "decode": ("encoder.", "in_proj.")}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _project(self, feats):
        if not hasattr(self, "in_proj"):
            return feats
        return conv1d(feats.transpose(1, 2), self.in_proj.w,
                      self.in_proj.b).transpose(1, 2)

    def _unproject(self, q):
        if not hasattr(self, "out_proj"):
            return q
        return conv1d(q.transpose(1, 2), self.out_proj.w,
                      self.out_proj.b).transpose(1, 2)

    def _decode(self, x):
        """[B, N, H] → waveform [B, T]."""
        return self.decoder(x.transpose(1, 2))[:, 0]

    def _sig_to_feats(self, sig, length):
        del length
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_toks(self, sig, length):
        return rvq_encode(self._project(self._sig_to_feats(sig, length)),
                          self.codebooks, self.config.num_codebooks)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        return self._decode(self._unproject(rvq_decode(toks, self.codebooks)))

    def _feats_to_sig(self, feats, length):
        return self._decode(feats)

    def embs(self) -> torch.Tensor:
        """``[K, C, D]`` codebook embeddings of the used stages."""
        return self.codebooks[: self.config.num_codebooks]


def init_seanet_rvq_params(generator: torch.Generator,
                           cfg: SEANetRVQConfig) -> dict:
    """Random weights as a flat state dict, in the reference package's
    distributions (the draws differ from ``jax.random``'s): SEANet stacks
    as EnCodec's, codebooks N(0, 1), projectors N(0, 1/in) with zero
    biases."""
    sea = cfg.seanet()
    out = {}
    for name, plan in (("encoder", seanet_encoder_plan(sea)),
                       ("decoder", seanet_decoder_plan(sea))):
        for k, v in init_seanet_params(generator, sea, plan).items():
            out[f"{name}.{k}"] = v
    H, D = cfg.hidden_size, cfg.codebook_dim
    out["codebooks"] = torch.randn((cfg.num_quantizers, cfg.codebook_size, D),
                                   generator=generator)
    if cfg.has_projector:
        out["in_proj.w"] = torch.randn(D, H, 1, generator=generator) * H**-0.5
        out["in_proj.b"] = torch.zeros(D)
        out["out_proj.w"] = torch.randn(H, D, 1, generator=generator) * D**-0.5
        out["out_proj.b"] = torch.zeros(H)
    return out
