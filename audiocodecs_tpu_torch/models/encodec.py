"""EnCodec, PyTorch.

Counterpart of ``audiocodecs_tpu/models/encodec.py`` for the 24 kHz model:
SEANet encoder → residual LSTM bottleneck → RVQ → tokens, and tokens → RVQ
decode → SEANet decoder. ``num_codebooks`` selects the first K RVQ stages.
The two LSTMs and the eight residual blocks run the package's CUDA kernels
on the card.

Streaming (:meth:`Encodec.encode_chunk`, :meth:`Encodec.decode_chunk`) runs
chunks of whole frames with carried conv and LSTM state: each conv is a
library call over the chunk and its left context, and each LSTM layer one
recurrence kernel launch over the chunk's frames. Batch mode reflect-pads
the signal's start and streaming starts from zero context, so the first
frames' tokens may differ from batch mode; with ``pad_mode="constant"`` the
two agree exactly.

Not ported yet, and refused rather than run wrong: the 48 kHz chunked and
loudness-normalized path (``chunk_length_s``/``normalize``) and the Vocos
decoder (``use_vocos``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import (
    Codec,
    CodecConfig,
    _serving,
    prune_params_for_mode,
)
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    apply_plan_streaming,
    init_seanet_params,
    init_stream_state,
    seanet_decoder_plan,
    seanet_encoder_plan,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["Encodec", "EncodecModelConfig", "init_encodec_params",
           "prune_params_for_mode"]


@dataclasses.dataclass(frozen=True)
class EncodecModelConfig:
    """Architecture hyperparameters (defaults = encodec_24khz checkpoint)."""

    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 32
    hidden_size: int = 128
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
    trim_right_ratio: float = 1.0
    normalize: bool = False
    chunk_length_s: Optional[float] = None
    overlap: Optional[float] = None
    codebook_size: int = 1024
    codebook_dim: int = 128
    num_quantizers: int = 32

    @property
    def chunk_length(self) -> Optional[int]:
        if self.chunk_length_s is None:
            return None
        return int(self.chunk_length_s * self.sampling_rate)

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
            trim_right_ratio=self.trim_right_ratio,
        )

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsampling_ratios)


class Encodec(Codec):
    """EnCodec codec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract.

    ``state_dict`` (e.g. from :func:`audiocodecs_tpu_torch.params.
    from_jax_params`) is loaded strictly; without it the weights are drawn
    by :func:`init_encodec_params` from ``generator`` (seed 0 by default).
    ``device=None`` means the card.
    """

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 24000,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        use_vocos: bool = False,
        model_config: Optional[EncodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        mc = model_config or EncodecModelConfig(sampling_rate=orig_sample_rate)
        if use_vocos:
            raise NotImplementedError("the Vocos decoder is not ported yet")
        if mc.chunk_length is not None or mc.normalize:
            raise NotImplementedError(
                "the chunked, loudness-normalized (48 kHz) path is not "
                "ported yet")
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        sea = mc.seanet()
        if mode != "decode":
            self.encoder = SEANet(sea, seanet_encoder_plan(sea))
        if mode != "encode":
            self.decoder = SEANet(sea, seanet_decoder_plan(sea))
        self.codebooks = nn.Parameter(torch.empty(
            mc.num_quantizers, mc.codebook_size, mc.codebook_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_encodec_params(generator, mc)
        self.load_state_dict(prune_params_for_mode(state_dict, mode),
                             strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode_feats(self, sig, length):
        del length  # masking is caller-side padding; encode is causal
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_feats(self, sig, length):
        return self._encode_feats(sig, length)

    def _sig_to_toks(self, sig, length):
        feats = self._encode_feats(sig, length)
        return rvq_encode(feats, self.codebooks, self.config.num_codebooks)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        return self._feats_to_sig(rvq_decode(toks, self.codebooks), length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))[:, 0]

    def embs(self) -> torch.Tensor:
        """``[K, C, H]`` codebook embeddings of the used stages."""
        return self.codebooks[: self.config.num_codebooks]

    # Streaming (chunked-causal) API, causal configs only ----------------- #

    @property
    def frame_size(self) -> int:
        """Samples a token frame (the chunk granularity)."""
        return self.model_config.hop_length

    def init_streaming_state(self, batch: int) -> dict:
        """Zero state for chunked encode and decode, on the codec's device."""
        state = {}
        if hasattr(self, "encoder"):
            state["encoder"] = init_stream_state(self.encoder, batch)
        if hasattr(self, "decoder"):
            state["decoder"] = init_stream_state(self.decoder, batch)
        return state

    @_serving
    def encode_chunk(self, chunk, state):
        """One chunk ``[B, frame_size·m]`` at the model's rate → (tokens
        ``[B, m, K]``, new state)."""
        chunk = self._tensor(chunk, torch.float32)
        new_state = dict(state)
        x, new_state["encoder"] = apply_plan_streaming(
            chunk[:, None, :], self.encoder, state["encoder"])
        toks = rvq_encode(x.transpose(1, 2), self.codebooks,
                          self.config.num_codebooks)
        return toks, new_state

    @_serving
    def decode_chunk(self, toks, state):
        """Token frames ``[B, m, K]`` → (waveform ``[B, frame_size·m]``, new
        state)."""
        toks = self._tensor(toks, torch.int64)
        new_state = dict(state)
        y, new_state["decoder"] = apply_plan_streaming(
            rvq_decode(toks, self.codebooks).transpose(1, 2), self.decoder,
            state["decoder"])
        return y[:, 0], new_state


def init_encodec_params(generator: torch.Generator,
                        cfg: EncodecModelConfig) -> dict:
    """Random weights as a flat state dict (the reference package's
    distributions, drawn from ``generator``)."""
    sea = cfg.seanet()
    out = {}
    for name, plan in (("encoder", seanet_encoder_plan(sea)),
                       ("decoder", seanet_decoder_plan(sea))):
        for k, v in init_seanet_params(generator, sea, plan).items():
            out[f"{name}.{k}"] = v
    out["codebooks"] = torch.randn(
        (cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim),
        generator=generator)
    return out

