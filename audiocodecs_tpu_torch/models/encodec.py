"""EnCodec, PyTorch.

Counterpart of ``audiocodecs_tpu/models/encodec.py``: SEANet encoder →
residual LSTM bottleneck → RVQ → tokens, and tokens → RVQ decode → SEANet
decoder. ``num_codebooks`` selects the first K RVQ stages. The LSTMs and
the causal residual blocks run the package's CUDA kernels on the card.

Two options of the reference, both ported:

* ``use_vocos``: a Vocos head (:mod:`..nn.vocos`) replaces the SEANet
  decoder, conditioned on the bandwidth id ``[1.5, 3, 6, 12].index(K·75/
  100)`` (``charactr/vocos-encodec-24khz``).
* ``chunk_length_s``/``overlap``/``normalize`` (the 48 kHz model): the
  signal is cut into windows at offsets ``range(0, T, stride)``, the
  trailing one zero-padded to the full window; each window is divided by
  its RMS over the whole window, padding included; all windows go through
  one encoder call as a ``[B·n, L]`` batch. Decode runs every window's
  tokens through one decoder call and overlap-adds them with triangle
  weights (``stride·(n − 1) + L`` samples, not trimmed). ``sig_to_feats``
  and ``feats_to_sig`` do not chunk, as in the reference; ``normalize``
  divides by the RMS there too.

Streaming (:meth:`Encodec.encode_chunk`, :meth:`Encodec.decode_chunk`) runs
chunks of whole frames with carried conv and LSTM state: each conv is a
library call over the chunk and its left context, and each LSTM layer one
recurrence kernel launch over the chunk's frames. Batch mode reflect-pads
the signal's start and streaming starts from zero context, so the first
frames' tokens may differ from batch mode; with ``pad_mode="constant"`` the
two agree exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig, _serving
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    SEANetConfig,
    apply_plan_streaming,
    init_seanet_params,
    init_stream_state,
    seanet_decoder_plan,
    seanet_encoder_plan,
    stack_forms,
)
from audiocodecs_tpu_torch.nn.vocos import (
    Vocos,
    VocosConfig,
    apply_vocos,
    init_vocos_params,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["Encodec", "EncodecModelConfig", "SEANetStreaming",
           "init_encodec_params", "prune_params_for_mode"]

# bandwidths (kbps) of the Vocos head's AdaLN rows
_VOCOS_BANDWIDTHS = [1.5, 3.0, 6.0, 12.0]


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

    @property
    def chunk_stride(self) -> Optional[int]:
        if self.chunk_length_s is None:
            return self.chunk_length
        return max(1, int((1.0 - (self.overlap or 0.0)) * self.chunk_length))

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


class SEANetStreaming:
    """Chunked-causal encode and decode for a codec made of SEANet stacks
    ``encoder``/``decoder`` around an RVQ over ``codebooks``, with
    ``_project``/``_unproject`` around the quantizer (identity here). Causal
    configs only: the carried state replaces the left padding."""

    @property
    def frame_size(self) -> int:
        """Samples a token frame (the chunk granularity)."""
        return math.prod(self.model_config.upsampling_ratios)

    def _project(self, feats):
        return feats

    def _unproject(self, q):
        return q

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
        toks = rvq_encode(self._project(x.transpose(1, 2)), self.codebooks,
                          self.config.num_codebooks)
        return toks, new_state

    @_serving
    def decode_chunk(self, toks, state):
        """Token frames ``[B, m, K]`` → (waveform ``[B, frame_size·m]``, new
        state)."""
        toks = self._tensor(toks, torch.int64)
        new_state = dict(state)
        q = self._unproject(rvq_decode(toks, self.codebooks))
        y, new_state["decoder"] = apply_plan_streaming(
            q.transpose(1, 2), self.decoder, state["decoder"])
        return y[:, 0], new_state


class Encodec(SEANetStreaming, Codec):
    """EnCodec codec with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract.

    ``state_dict`` (e.g. from :func:`audiocodecs_tpu_torch.params.
    from_jax_params`) is loaded strictly; without it the codec's weights are
    drawn by :func:`init_encodec_params` from ``generator`` (seed 0 by
    default) and, with ``use_vocos``, the head's from a generator of its
    own seeded 1, as the reference draws them from ``PRNGKey(1)``.
    ``device=None`` means the card.

    ``decode_dtype`` and ``decode_precision`` set the decoder stack's form
    (:class:`..nn.layers.DecodeForm`: the reference's serving tiers, which
    :mod:`audiocodecs_tpu_torch.serving` picks by family) and
    ``encode_precision`` the encoder stack's (:func:`..nn.seanet.
    stack_forms`). The quantizer and the LSTMs stay exact fp32 in every
    form, as the reference fixes them at HIGHEST. The Vocos head reads no
    form (the reference's Vocos reads no activation dtype), so with
    ``use_vocos`` the decoder's form changes nothing.
    """

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 24000,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        use_vocos: bool = False,
        vocos_config: Optional[VocosConfig] = None,
        model_config: Optional[EncodecModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        encode_precision: str = "exact",
    ):
        mc = model_config or EncodecModelConfig(sampling_rate=orig_sample_rate)
        bandwidth_id = 0
        if use_vocos:
            if mc.chunk_length is not None:
                raise ValueError(
                    "use_vocos does not compose with windowed chunking "
                    "(chunk_length_s): overlapped token windows are not a "
                    "contiguous stream")
            vocos_config = vocos_config or VocosConfig(
                input_channels=mc.codebook_dim)
            try:
                bandwidth_id = _VOCOS_BANDWIDTHS.index(num_codebooks * 75
                                                       / 100)
            except ValueError:
                raise ValueError(f"use_vocos supports num_codebooks ∈ "
                                 f"{{2,4,8,16}}, got {num_codebooks}") from None
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        self.use_vocos = use_vocos
        self.vocos_config = vocos_config if use_vocos else None
        self._bandwidth_id = bandwidth_id  # the AdaLN row
        sea = mc.seanet()
        self.encode_form, self.decode_form = stack_forms(
            decode_dtype, decode_precision, encode_precision)
        if mode != "decode":
            self.encoder = SEANet(sea, seanet_encoder_plan(sea),
                                  self.encode_form)
        if mode != "encode":
            if use_vocos:
                self.vocos = Vocos(self.vocos_config)
            else:
                self.decoder = SEANet(sea, seanet_decoder_plan(sea),
                                      self.decode_form)
        self.codebooks = nn.Parameter(torch.empty(
            mc.num_quantizers, mc.codebook_size, mc.codebook_dim))
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_encodec_params(generator, mc)
            if use_vocos:
                vocos = init_vocos_params(torch.Generator().manual_seed(1),
                                          self.vocos_config)
                state_dict.update({f"vocos.{k}": v for k, v in vocos.items()})
        self.load_state_dict(prune_params_for_mode(state_dict, mode,
                                                   use_vocos), strict=True)
        self.to(self.device)
        self.eval()

    # Pure functions over tensors on the codec's device -------------------- #

    def _encode_feats(self, sig, length):
        del length  # masking is caller-side padding; encode is causal
        if self.model_config.normalize:
            sig = _rms_normalize(sig)
        return self.encoder(sig[:, None, :]).transpose(1, 2)

    def _sig_to_feats(self, sig, length):
        return self._encode_feats(sig, length)

    def _sig_to_toks(self, sig, length):
        if self.model_config.chunk_length is not None:
            return self._chunked_sig_to_toks(sig)
        feats = self._encode_feats(sig, length)
        return rvq_encode(feats, self.codebooks, self.config.num_codebooks)

    def _chunk_frames(self, sig):
        """[B, T] → [B, n, L] windows at offsets ``range(0, T, stride)``,
        the trailing one zero-padded to the full window."""
        T = sig.shape[1]
        L = self.model_config.chunk_length
        S = self.model_config.chunk_stride
        n = max(1, -(-T // S))
        total = (n - 1) * S + L
        if total > T:
            sig = torch.nn.functional.pad(sig, (0, total - T))
        return torch.stack([sig[:, i * S:i * S + L] for i in range(n)], 1)

    def _chunked_sig_to_toks(self, sig):
        frames = self._chunk_frames(sig)
        B, n, L = frames.shape
        x = frames.reshape(B * n, L)
        if self.model_config.normalize:
            # each window's scale over the full window, padding included
            x = _rms_normalize(x)
        feats = self.encoder(x[:, None, :]).transpose(1, 2)
        toks = rvq_encode(feats, self.codebooks, self.config.num_codebooks)
        return toks.reshape(B, n * toks.shape[1], toks.shape[2])

    def _chunked_toks_to_sig(self, toks):
        B, N, K = toks.shape
        frames_per_chunk = (self.model_config.chunk_length
                            // self.model_config.hop_length)
        if N % frames_per_chunk != 0:
            raise ValueError(
                f"chunked decode needs N divisible by {frames_per_chunk} "
                f"frames/chunk, got N={N}")
        n = N // frames_per_chunk
        q = rvq_decode(toks.reshape(B * n, frames_per_chunk, K),
                       self.codebooks)
        sig = self.decoder(q.transpose(1, 2))[:, 0]
        return _linear_overlap_add(sig.reshape(B, n, -1),
                                   self.model_config.chunk_stride)

    def _sig_to_qfeats(self, sig, length):
        return rvq_decode(self._sig_to_toks(sig, length), self.codebooks)

    def _toks_to_qfeats(self, toks, length):
        return rvq_decode(toks, self.codebooks)

    def _toks_to_sig(self, toks, length):
        if self.model_config.chunk_length is not None:
            return self._chunked_toks_to_sig(toks)
        q = rvq_decode(toks, self.codebooks)
        if self.use_vocos:
            return apply_vocos(self.vocos, q, self.vocos_config,
                               cond_id=self._bandwidth_id)
        return self._feats_to_sig(q, length)

    def _feats_to_sig(self, feats, length):
        return self.decoder(feats.transpose(1, 2))[:, 0]

    def embs(self) -> torch.Tensor:
        """``[K, C, H]`` codebook embeddings of the used stages."""
        return self.codebooks[: self.config.num_codebooks]


def _rms_normalize(sig: torch.Tensor) -> torch.Tensor:
    """Loudness normalization: ``sig / (rms(sig) + 1e-8)`` over the last
    axis. The scale is not applied back on decode, as in the reference."""
    return sig / (torch.sqrt(torch.mean(sig * sig, dim=-1, keepdim=True))
                  + 1e-8)


def _linear_overlap_add(chunks: torch.Tensor, stride: int) -> torch.Tensor:
    """Triangle-weighted overlap-add of ``chunks`` [B, n, L] decoded at
    offsets ``i·stride`` → [B, stride·(n − 1) + L]. The weights peak
    mid-window; dividing by their sum makes the crossfade linear where two
    windows overlap and a no-op where one covers a sample alone."""
    B, n, L = chunks.shape
    t = torch.arange(1, L + 1, dtype=chunks.dtype,
                     device=chunks.device) / (L + 1)
    w = 0.5 - torch.abs(t - 0.5)
    total = stride * (n - 1) + L
    out = chunks.new_zeros((B, total))
    wsum = chunks.new_zeros((total,))
    for i in range(n):
        out[:, i * stride:i * stride + L] += w * chunks[:, i]
        wsum[i * stride:i * stride + L] += w
    return out / wsum


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


def prune_params_for_mode(state_dict: dict, mode: str,
                          use_vocos: bool = False) -> dict:
    """Drop the entries a mode does not use (encode: no decoder and no
    Vocos head; decode: no encoder); with ``use_vocos`` the head replaces
    the SEANet decoder, which is dropped in every mode."""
    drop = {"encode": ("decoder.", "vocos."),
            "decode": ("encoder.",)}.get(mode, ())
    if use_vocos:
        drop += ("decoder.",)
    return {k: v for k, v in state_dict.items() if not k.startswith(drop)}
