"""Mimi (Kyutai's Moshi codec), PyTorch.

Counterpart of ``audiocodecs_tpu/models/mimi.py``, weight-compatible with
its param tree through :func:`audiocodecs_tpu_torch.params.from_jax_params`:

causal SEANet conv encoder (zero padding, no LSTM, identity shortcuts) →
8-layer transformer (RoPE, LayerScale, sliding-window causal attention) →
stride-2 downsample conv, replicate-padded (25 Hz → 12.5 Hz) → **split
RVQ** (1 semantic + N acoustic codebooks, each side with its own input and
output projections) → grouped upsample transposed conv (groups = 512) →
decoder transformer → SEANet conv decoder.

``num_codebooks`` counts all codebooks, semantic first. Mode pruning drops
the other tower with its transformer and its down/upsample conv.

Streaming (:meth:`Mimi.encode_chunk`, :meth:`Mimi.decode_chunk`) runs
chunks of whole 12.5 Hz frames with carried conv state and the
transformers' rolling K/V windows. The downsample conv's state is filled
with the stream's first frame (replicate padding, as in batch mode), so
chunked and batch execution agree.

Mimi runs none of the package's CUDA kernels: it has no LSTM and no conv
shortcut. Its convs are cuDNN and its transformer's products cuBLAS, all in
full fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from audiocodecs_tpu_torch.codec import Codec, CodecConfig, _serving
from audiocodecs_tpu_torch.nn.layers import (
    Conv1d,
    ConvTranspose1d,
    conv_transpose1d,
    exact_fp32,
)
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
from audiocodecs_tpu_torch.nn.streaming import (
    apply_transformer_streaming,
    conv_stream,
    convtr_stream,
    init_conv_state,
    init_convtr_state,
    init_transformer_stream_state,
)
from audiocodecs_tpu_torch.nn.transformer import (
    Transformer,
    TransformerConfig,
    init_transformer_params,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_decode, rvq_encode

__all__ = ["Mimi", "MimiModelConfig", "init_mimi_params"]

# state-dict prefixes of each tower
_TOWERS = {"encode": ("decoder.", "decoder_transformer.", "upsample."),
           "decode": ("encoder.", "encoder_transformer.", "downsample.")}


@dataclasses.dataclass(frozen=True)
class MimiModelConfig:
    """Defaults = the kyutai/mimi checkpoint."""

    sampling_rate: int = 24000
    audio_channels: int = 1
    num_filters: int = 64
    hidden_size: int = 512
    upsampling_ratios: tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    num_residual_layers: int = 1
    compress: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "constant"
    use_conv_shortcut: bool = False
    trim_right_ratio: float = 1.0
    # transformer
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01
    # quantizer
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    frame_rate: float = 12.5
    encodec_frame_rate: float = 25.0
    upsample_groups: int = 512

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
            num_lstm_layers=0,
            causal=self.use_causal_conv,
            pad_mode=self.pad_mode,
            use_conv_shortcut=self.use_conv_shortcut,
            trim_right_ratio=self.trim_right_ratio,
        )

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.hidden_size,
            num_layers=self.num_hidden_layers,
            num_heads=self.num_attention_heads,
            num_kv_heads=self.num_key_value_heads,
            head_dim=self.head_dim,
            intermediate_size=self.intermediate_size,
            act="gelu",
            norm="layernorm",
            norm_eps=self.norm_eps,
            rope_theta=self.rope_theta,
            use_layer_scale=True,
            sliding_window=self.sliding_window,
            attention_bias=False,
            causal=True,
        )

    @property
    def downsample_stride(self) -> int:
        return int(self.encodec_frame_rate / self.frame_rate)


class RVQSide(nn.Module):
    """One side of the split RVQ: ``in_proj`` [H, D], ``out_proj`` [D, H],
    ``codebooks`` [n, C, D]."""

    def __init__(self, cfg: MimiModelConfig, n: int):
        super().__init__()
        H, D = cfg.hidden_size, cfg.codebook_dim
        self.in_proj = nn.Parameter(torch.empty(H, D))
        self.out_proj = nn.Parameter(torch.empty(D, H))
        self.codebooks = nn.Parameter(torch.empty(n, cfg.codebook_size, D))


class SplitRVQ(nn.Module):
    def __init__(self, cfg: MimiModelConfig):
        super().__init__()
        ns = cfg.num_semantic_quantizers
        self.semantic = RVQSide(cfg, ns)
        self.acoustic = RVQSide(cfg, cfg.num_quantizers - ns)


def _split_rvq_encode(q: SplitRVQ, emb, num_codebooks: int,
                      num_semantic: int) -> torch.Tensor:
    """[B, N, hidden] → [B, N, K]; semantic stage(s) first, then acoustic."""
    with exact_fp32():
        z = torch.matmul(emb, q.semantic.in_proj)
    parts = [rvq_encode(z, q.semantic.codebooks, num_semantic)]
    if num_codebooks > num_semantic:
        with exact_fp32():
            z = torch.matmul(emb, q.acoustic.in_proj)
        parts.append(rvq_encode(z, q.acoustic.codebooks,
                                num_codebooks - num_semantic))
    return torch.cat(parts, dim=-1)


def _split_rvq_decode(q: SplitRVQ, toks, num_semantic: int) -> torch.Tensor:
    """[B, N, K] → [B, N, hidden]."""
    with exact_fp32():
        out = torch.matmul(
            rvq_decode(toks[..., :num_semantic], q.semantic.codebooks),
            q.semantic.out_proj)
        if toks.shape[-1] > num_semantic:
            out = out + torch.matmul(
                rvq_decode(toks[..., num_semantic:], q.acoustic.codebooks),
                q.acoustic.out_proj)
    return out


class Mimi(Codec):
    """Mimi with the standardized ``[B,T]`` ↔ ``[B,N,K]`` contract.
    ``state_dict`` is loaded strictly; without it the weights are drawn by
    :func:`init_mimi_params` from ``generator`` (seed 0 by default).
    ``device=None`` means the card.

    ``decode_dtype`` and ``decode_precision`` set the decoder stack's form
    (:class:`..nn.layers.DecodeForm`: the reference's serving tiers, which
    :mod:`audiocodecs_tpu_torch.serving` picks by family) and
    ``encode_precision`` the encoder stack's (:func:`..nn.seanet.
    stack_forms`). The quantizer and the LSTMs stay exact fp32 in every
    form, as the reference fixes them at HIGHEST. The encoder's form also
    covers the downsample conv (the reference runs it at
    ``ACX_CONV_PRECISION``); the transformers stay exact fp32 and the
    decoder's form covers its SEANet stack only, as the reference casts
    only that stack.
    """

    @classmethod
    def default_model_config(cls, orig_sample_rate: int = 24000):
        return MimiModelConfig(sampling_rate=orig_sample_rate)

    def __init__(
        self,
        sample_rate: int,
        orig_sample_rate: int = 24000,
        mode: str = "reconstruct",
        num_codebooks: int = 8,
        model_config: Optional[MimiModelConfig] = None,
        state_dict: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        decode_dtype: torch.dtype = torch.float32,
        decode_precision: str = "exact",
        encode_precision: str = "exact",
    ):
        mc = model_config or MimiModelConfig(sampling_rate=orig_sample_rate)
        super().__init__(
            CodecConfig(sample_rate=sample_rate,
                        orig_sample_rate=orig_sample_rate, mode=mode,
                        num_codebooks=num_codebooks,
                        vocab_size=mc.codebook_size),
            device=device)
        self.model_config = mc
        sea, tcfg = mc.seanet(), mc.transformer()
        H, kernel = mc.hidden_size, 2 * mc.downsample_stride
        self.encode_form, self.decode_form = stack_forms(
            decode_dtype, decode_precision, encode_precision)
        if mode != "decode":
            self.encoder = SEANet(sea, seanet_encoder_plan(sea),
                                  self.encode_form)
            self.encoder_transformer = Transformer(tcfg)
            self.downsample = Conv1d(H, H, kernel, bias=False)
        if mode != "encode":
            self.decoder = SEANet(sea, seanet_decoder_plan(sea),
                                  self.decode_form)
            self.decoder_transformer = Transformer(tcfg)
            self.upsample = ConvTranspose1d(H, H, kernel, bias=False,
                                            groups=mc.upsample_groups)
        self.quantizer = SplitRVQ(mc)
        if state_dict is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            state_dict = init_mimi_params(generator, mc)
        drop = _TOWERS.get(mode, ())
        self.load_state_dict({k: v for k, v in state_dict.items()
                              if not k.startswith(drop)}, strict=True)
        self.to(self.device)
        self.eval()

    # Towers --------------------------------------------------------------- #

    def _encode_tower(self, sig):
        """Waveform [B, T] → pre-quantization embeddings [B, N, hidden]."""
        mc = self.model_config
        x = self.encoder(sig[:, None, :])
        x = self.encoder_transformer(x.transpose(1, 2))
        x = self.encode_form.causal_conv1d(
            x.transpose(1, 2), self.downsample, stride=mc.downsample_stride,
            causal=mc.use_causal_conv, pad_mode="replicate")
        return x.transpose(1, 2)

    def _decode_tower(self, q):
        """Quantized embeddings [B, N, hidden] → waveform [B, T]."""
        mc = self.model_config
        stride = mc.downsample_stride
        y = conv_transpose1d(q.transpose(1, 2), self.upsample.w, None,
                             stride=stride, groups=mc.upsample_groups)
        padding_total = 2 * stride - stride  # kernel − stride
        right = math.ceil(padding_total * mc.trim_right_ratio)
        y = y[..., padding_total - right: y.shape[-1] - right]
        y = self.decoder_transformer(y.transpose(1, 2))
        return self.decoder(y.transpose(1, 2))[:, 0]

    def _encode(self, emb):
        return _split_rvq_encode(self.quantizer, emb,
                                 self.config.num_codebooks,
                                 self.model_config.num_semantic_quantizers)

    def _decode(self, toks):
        return _split_rvq_decode(self.quantizer, toks,
                                 self.model_config.num_semantic_quantizers)

    def _sig_to_feats(self, sig, length):
        del length
        return self._encode_tower(sig)

    def _sig_to_toks(self, sig, length):
        return self._encode(self._encode_tower(sig))

    def _sig_to_qfeats(self, sig, length):
        return self._decode(self._sig_to_toks(sig, length))

    def _toks_to_qfeats(self, toks, length):
        return self._decode(toks)

    def _toks_to_sig(self, toks, length):
        return self._decode_tower(self._decode(toks))

    def embs(self) -> torch.Tensor:
        """``[K, C, D]`` VQ-space codebooks, semantic then acoustic."""
        K = self.config.num_codebooks
        ns = self.model_config.num_semantic_quantizers
        parts = [self.quantizer.semantic.codebooks[:ns]]
        if K > ns:
            parts.append(self.quantizer.acoustic.codebooks[: K - ns])
        return torch.cat(parts, dim=0)

    # Streaming (chunked-causal) API ---------------------------------------- #

    @property
    def frame_size(self) -> int:
        """Samples a token frame (the chunk granularity)."""
        return math.prod(self.model_config.upsampling_ratios) * (
            self.model_config.downsample_stride)

    def init_streaming_state(self, batch: int) -> dict:
        """Zero state for chunked encode and decode, on the codec's device.
        Chunks must be whole frames (``frame_size`` samples)."""
        mc = self.model_config
        tcfg, dev = mc.transformer(), self.device
        stride, H = mc.downsample_stride, mc.hidden_size
        state = {}
        if hasattr(self, "encoder"):
            state["encoder"] = init_stream_state(self.encoder, batch)
            state["encoder_transformer"] = init_transformer_stream_state(
                tcfg, batch, device=dev)
            state["downsample"] = init_conv_state(batch, 2 * stride, stride,
                                                  H, device=dev)
            state["downsample_init"] = False
        if hasattr(self, "decoder"):
            state["decoder"] = init_stream_state(self.decoder, batch)
            state["decoder_transformer"] = init_transformer_stream_state(
                tcfg, batch, device=dev)
            state["upsample"] = init_convtr_state(batch, 2 * stride, stride,
                                                  H, device=dev)
        return state

    @_serving
    def encode_chunk(self, chunk, state):
        """One chunk ``[B, frame_size·m]`` → (tokens ``[B, m, K]``, new
        state)."""
        mc = self.model_config
        chunk = self._tensor(chunk, torch.float32)
        new_state = dict(state)
        x, new_state["encoder"] = apply_plan_streaming(
            chunk[:, None, :], self.encoder, state["encoder"])
        x, new_state["encoder_transformer"] = apply_transformer_streaming(
            self.encoder_transformer, x.transpose(1, 2), mc.transformer(),
            state["encoder_transformer"])
        x = x.transpose(1, 2)
        ds = state["downsample"]
        if not state["downsample_init"]:
            # replicate padding at stream start, as in batch mode
            ds = x[..., :1].expand(-1, -1, ds.shape[-1])
        x, new_state["downsample"] = conv_stream(
            x, ds, self.downsample.w, None, stride=mc.downsample_stride)
        new_state["downsample_init"] = True
        return self._encode(x.transpose(1, 2)), new_state

    @_serving
    def decode_chunk(self, toks, state):
        """Token frames ``[B, m, K]`` → (waveform ``[B, frame_size·m]``, new
        state)."""
        mc = self.model_config
        toks = self._tensor(toks, torch.int64)
        new_state = dict(state)
        y, new_state["upsample"] = convtr_stream(
            self._decode(toks).transpose(1, 2), state["upsample"],
            self.upsample.w, None, stride=mc.downsample_stride,
            groups=mc.upsample_groups)
        y, new_state["decoder_transformer"] = apply_transformer_streaming(
            self.decoder_transformer, y.transpose(1, 2), mc.transformer(),
            state["decoder_transformer"])
        y, new_state["decoder"] = apply_plan_streaming(
            y.transpose(1, 2), self.decoder, state["decoder"])
        return y[:, 0], new_state


def init_mimi_params(generator: torch.Generator, cfg: MimiModelConfig) -> dict:
    """Random weights as a flat state dict (the reference package's
    distributions, drawn from ``generator``)."""
    sea, tcfg = cfg.seanet(), cfg.transformer()
    H, D, k = cfg.hidden_size, cfg.codebook_dim, 2 * cfg.downsample_stride
    out = {}
    for name, plan in (("encoder", seanet_encoder_plan(sea)),
                       ("decoder", seanet_decoder_plan(sea))):
        for key, v in init_seanet_params(generator, sea, plan).items():
            out[f"{name}.{key}"] = v
    for name in ("encoder_transformer", "decoder_transformer"):
        out.update(init_transformer_params(generator, tcfg, prefix=f"{name}."))

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator) * scale

    out["downsample.w"] = normal(H, H, k, scale=0.02)
    out["upsample.w"] = normal(H, H // cfg.upsample_groups, k, scale=0.02)
    ns = cfg.num_semantic_quantizers
    for side, n in (("semantic", ns), ("acoustic", cfg.num_quantizers - ns)):
        out[f"quantizer.{side}.in_proj"] = normal(H, D, scale=0.05)
        out[f"quantizer.{side}.out_proj"] = normal(D, H, scale=0.05)
        out[f"quantizer.{side}.codebooks"] = normal(n, cfg.codebook_size, D,
                                                    scale=1.0)
    return out
