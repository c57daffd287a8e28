"""WavLM + K-means (a discrete SSL codec with a SEANet vocoder), PyTorch.

Counterpart of ``audiocodecs_tpu/models/wavlm_kmeans.py`` (the reference's
``discrete_wavlm_large``), weight-compatible with its param tree through
:func:`audiocodecs_tpu_torch.params.from_jax_params`. WavLM-large's hidden
states at the selected layers (``layer_ids``, (6,) by default) are each
quantized by a k-means codebook (512 centroids a layer, a Euclidean VQ:
one product and an argmax, :mod:`..quant.vq`), so K = len(layer_ids).
Decoding averages the layers' centroids, runs the ``dequantizer`` linear
and vocodes with a SEANet decoder (32 filters, ratios (8, 5, 4, 2): 50 Hz
frames to 16 kHz; non-causal, reflect padded, no LSTM, identity
shortcuts), or with ``vocoder_variant="hifigan"`` a HiFi-GAN generator
(:mod:`..nn.hifigan`: 512 channels, rates (10, 8, 2, 2), kernels (20, 16,
4, 4), hop 320).

The tower runs to the deepest selected layer and no further: the
reference asks for every hidden state and reads only these, so the
layers past them do not move its output. The tower and the VQ run in
exact fp32 (TF32 off).

The vocoder computes in a :class:`..nn.layers.DecodeForm`
(``decode_dtype``, ``decode_precision``): the reference's SEANet decoder
reads the activation dtype and the decoder's precision
(``nn/seanet._apply_plan`` under ``conv_role("decoder")``), so its
EnCodec-style tier decodes in bf16. Its residual blocks are non-causal,
which the fused SEANet block does not take: every conv is a cuDNN call in
the form, as the reference leaves them to XLA. The HiFi-GAN variant reads
no activation dtype and the reference opens no decoder scope around it
(``_vocode`` calls ``apply_hifigan`` on the dequantizer's fp32 output, whose
convs read only ``ACX_CONV_PRECISION``, "highest" in every tier), so it
decodes in exact fp32 in every tier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig
from audiocodecs_tpu_torch.nn.hifigan import (
    HiFiGAN,
    HiFiGANConfig,
    apply_hifigan,
    init_hifigan_params,
)
from audiocodecs_tpu_torch.nn.layers import DecodeForm
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    init_seanet_params,
    seanet_decoder_plan,
)
from audiocodecs_tpu_torch.nn.transformer import Linear, _linear
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
    wavlm_large_config,
)
from audiocodecs_tpu_torch.quant.vq import vq_decode, vq_encode

__all__ = ["WavLMKmeans", "WavLMKmeansModelConfig", "init_wavlm_kmeans_params",
           "seanet_vocoder_config"]


def seanet_vocoder_config(hidden: int, filters: int,
                          ratios: tuple[int, ...]) -> SEANetConfig:
    """The WavLM families' SEANet vocoder: non-causal, reflect padded, no
    LSTM, identity shortcuts."""
    return SEANetConfig(audio_channels=1, num_filters=filters,
                        hidden_size=hidden, ratios=ratios, num_lstm_layers=0,
                        causal=False, pad_mode="reflect",
                        use_conv_shortcut=False)


@dataclasses.dataclass(frozen=True)
class WavLMKmeansModelConfig:
    sampling_rate: int = 16000
    layer_ids: tuple[int, ...] = (6,)
    num_clusters: int = 512
    wavlm: WavLMConfig = dataclasses.field(default_factory=wavlm_large_config)
    vocoder_variant: str = "seanet"  # or "hifigan"
    vocoder_filters: int = 32
    vocoder_ratios: tuple[int, ...] = (8, 5, 4, 2)

    def vocoder(self) -> SEANetConfig:
        return seanet_vocoder_config(self.wavlm.hidden_size,
                                     self.vocoder_filters,
                                     self.vocoder_ratios)

    def hifigan(self) -> HiFiGANConfig:
        return HiFiGANConfig(num_mels=self.wavlm.hidden_size,
                             upsample_rates=(10, 8, 2, 2),  # 320 samples
                             upsample_kernel_sizes=(20, 16, 4, 4),
                             upsample_initial_channel=512)


class WavLMKmeans(Codec):
    """WavLM + K-means with the standardized ``[B,T]`` ↔ ``[B,N,K]``
    contract (50 Hz frames at 16 kHz).

    ``sig_to_feats`` is the mean of the selected layers' hidden states;
    ``feats_to_sig`` dequantizes and vocodes them. ``state_dict`` is loaded
    strictly; without it the weights are drawn by
    :func:`init_wavlm_kmeans_params` from ``generator`` (seed 0 by
    default). Encode mode drops the vocoder and the dequantizer, decode
    mode the tower. ``device=None`` means the card."""

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 16000):
        return WavLMKmeansModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 16000,
        mode: str = "reconstruct",
        num_codebooks: Optional[int] = None,
        layer_ids: Optional[tuple[int, ...]] = None,
        model_config: Optional[WavLMKmeansModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
    ):
        form = DecodeForm(decode_dtype, decode_precision)
        mc = model_config or WavLMKmeansModelConfig(
            sampling_rate=orig_sample_rate)
        if layer_ids is not None:
            mc = dataclasses.replace(mc, layer_ids=tuple(layer_ids))
        if mc.vocoder_variant not in ("seanet", "hifigan"):
            raise ValueError(f"unknown vocoder_variant "
                             f"{mc.vocoder_variant!r}")
        K = len(mc.layer_ids)
        if num_codebooks is not None and num_codebooks != K:
            raise ValueError(f"num_codebooks ({num_codebooks}) must equal "
                             f"len(layer_ids) ({K})")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=K, vocab_size=mc.num_clusters),
            device=device)
        self.model_config = mc
        self.decode_form = form
        H = mc.wavlm.hidden_size
        if mode != "decode":
            self.wavlm = WavLM(mc.wavlm)
        self.kmeans = nn.Parameter(torch.empty(K, mc.num_clusters, H))
        if mode != "encode":
            self.dequantizer = Linear(H, H, True)
            if mc.vocoder_variant == "hifigan":
                self.vocoder = HiFiGAN(mc.hifigan())
            else:
                voc = mc.vocoder()
                self.vocoder = SEANet(voc, seanet_decoder_plan(voc), form)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_wavlm_kmeans_params(generator, mc)
        drop = {"encode": ("vocoder.", "dequantizer."),
                "decode": ("wavlm.",)}.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _ssl_feats(self, sig):
        """``[B, T]`` → the selected layers' states ``[B, N, K, H]``."""
        mc = self.model_config
        hidden = apply_wavlm(self.wavlm, sig, mc.wavlm,
                             output_layer=max(mc.layer_ids),
                             output_hidden_states=True)
        return torch.stack([hidden[i] for i in mc.layer_ids], dim=2)

    def _sig_to_feats(self, sig, length):
        del length
        return self._ssl_feats(sig).mean(dim=2)

    def _sig_to_toks(self, sig, length):
        del length
        feats = self._ssl_feats(sig)
        return torch.stack([vq_encode(feats[:, :, k], self.kmeans[k])
                            for k in range(feats.shape[2])], dim=-1)

    def _toks_to_qfeats(self, toks, length):
        q = torch.stack([vq_decode(toks[..., k], self.kmeans[k])
                         for k in range(toks.shape[-1])], dim=2).mean(dim=2)
        return _linear(q, self.dequantizer)

    def _sig_to_qfeats(self, sig, length):
        return self._toks_to_qfeats(self._sig_to_toks(sig, length), length)

    def _vocode(self, h):
        """``[B, N, H]`` → ``[B, N·320]`` in the vocoder's form (HiFi-GAN:
        exact fp32)."""
        mc = self.model_config
        if mc.vocoder_variant == "hifigan":
            return apply_hifigan(self.vocoder, h.transpose(1, 2),
                                 mc.hifigan())
        return self.vocoder(h.transpose(1, 2))[:, 0]

    def _toks_to_sig(self, toks, length):
        return self._vocode(self._toks_to_qfeats(toks, length))

    def _feats_to_sig(self, feats, length):
        return self._vocode(_linear(feats, self.dequantizer))

    def embs(self) -> torch.Tensor:
        """The k-means centroids ``[K, C, H]``."""
        return self.kmeans.detach()


def init_wavlm_kmeans_params(generator: torch.Generator,
                             cfg: WavLMKmeansModelConfig) -> dict:
    """Random weights of :class:`WavLMKmeans` as a flat state dict, in the
    reference's distributions (the tower's :func:`..nn.wavlm.
    init_wavlm_params`, centroids N(0, 1), the dequantizer N(0, 1/H) with a
    zero bias, the vocoder's SEANet or HiFi-GAN init); the draws differ
    from the reference's."""
    H = cfg.wavlm.hidden_size
    out = init_wavlm_params(generator, cfg.wavlm, "wavlm.")
    out["kmeans"] = torch.randn((len(cfg.layer_ids), cfg.num_clusters, H),
                                generator=generator)
    out["dequantizer.w"] = torch.randn((H, H), generator=generator) * H ** -.5
    out["dequantizer.b"] = torch.zeros(H)
    if cfg.vocoder_variant == "hifigan":
        out.update(init_hifigan_params(generator, cfg.hifigan(), "vocoder."))
        return out
    voc = cfg.vocoder()
    out.update({f"vocoder.{k}": v for k, v in init_seanet_params(
        generator, voc, seanet_decoder_plan(voc)).items()})
    return out
