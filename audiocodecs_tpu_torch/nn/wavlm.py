"""WavLM and wav2vec2 SSL encoders, PyTorch.

Counterpart of ``audiocodecs_tpu/nn/wavlm.py``: the tower under WavLM +
K-means, DyCAST and FocalCodec (WavLM) and BiCodec (wav2vec2-XLSR). Three
configurations of one module:

* WavLM-base (:class:`WavLMConfig`): post-norm layers, a GroupNorm (one
  group a channel) after the first conv of the feature extractor;
* WavLM-large (:func:`wavlm_large_config`): pre-norm ("stable layer norm")
  layers, a LayerNorm after each conv, conv biases;
* wav2vec2-large-XLSR-53 (:func:`wav2vec2_xlsr_config`): WavLM-large's
  shape with plain softmax attention (``gated_rel_pos=False``).

The pieces: the conv feature extractor (7 convs of 512 channels, kernels
10, 3, 3, 3, 3, 2, 2, strides 5, 2, 2, 2, 2, 2, 2, exact GELU); the
feature projection (LayerNorm, a linear to the hidden width); the
positional conv (k = 128, 16 groups, zero padded 64 a side, its last
output dropped for the even kernel, GELU) added to the input; and the
layers, whose attention adds, with ``gated_rel_pos``, WavLM's gated
relative-position bias: a T5-style bucket table (320 buckets, distances to
800) gathers ``rel_attn_embed [buckets, heads]`` once into ``[H, T, T]``,
and each layer scales it by a GRU-style gate of its query states.

The bucket table is computed in float64 numpy, as the reference's trace
-time constant is, so no distance moves across a bucket edge on another
device. Variances are population variances. Attention is two batched
products and the additive bias in fp32 (:func:`..nn.transformer.
attention`), not ``scaled_dot_product_attention``: the reference's
products are HIGHEST, and these features set tokens (WavLM + K-means'
distances, DyCAST's boundaries, FocalCodec's sign bits, BiCodec's VQ).
Every product and conv runs in exact fp32 (TF32 off). No TPU kernel
covers this module.

Weights keep the reference's names: ``feature_extractor.conv_layers.<i>``
(a conv with its ``ln`` or ``gn``), ``proj_ln``, ``proj``, ``pos_conv``
(a 16-group conv, ``[H, H/16, 128]`` here), ``encoder_ln``,
``rel_attn_embed`` and ``layers.<i>`` (``q``, ``k``, ``v``, ``o``,
``gru_w``, ``gru_b``, ``gru_const``, ``ln1``, ``ff1``, ``ff2``, ``ln2``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, conv1d, exact_fp32
from audiocodecs_tpu_torch.nn.transformer import (
    Linear,
    Norm,
    _linear,
    _norm,
    attention,
)

__all__ = ["WavLMConfig", "WavLM", "apply_wavlm", "init_wavlm_params",
           "rel_pos_buckets", "wav2vec2_xlsr_config", "wavlm_large_config"]


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = False  # pre-norm layers (WavLM-large)
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    gated_rel_pos: bool = True  # False: wav2vec2's plain attention

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def wavlm_large_config() -> WavLMConfig:
    """microsoft/wavlm-large's shape."""
    return WavLMConfig(
        hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, conv_bias=True,
        do_stable_layer_norm=True, feat_extract_norm="layer")


def wav2vec2_xlsr_config() -> WavLMConfig:
    """facebook/wav2vec2-large-xlsr-53's shape (plain attention)."""
    return dataclasses.replace(wavlm_large_config(), gated_rel_pos=False)


# ----------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# ----------------------------------------------------------------------- #


class _FeatConv(Conv1d):
    """A feature-extractor conv with its norm: ``ln`` (LayerNorm over the
    channels), ``gn`` (one group a channel) or none."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 bias: bool, norm: str | None):
        super().__init__(cin, cout, k, bias)
        self.stride, self.norm = stride, norm
        if norm is not None:
            self.add_module(norm, Norm(cout, "layernorm"))


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        layers, cin = [], 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                          cfg.conv_stride)):
            norm = ("ln" if cfg.feat_extract_norm == "layer"
                    else "gn" if i == 0 else None)
            layers.append(_FeatConv(cin, c, k, s, cfg.conv_bias, norm))
            cin = c
        self.conv_layers = nn.ModuleList(layers)


class _Layer(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        self.q, self.k = Linear(H, H, True), Linear(H, H, True)
        self.v, self.o = Linear(H, H, True), Linear(H, H, True)
        if cfg.gated_rel_pos:
            self.gru_w = nn.Parameter(torch.empty(D, 8))
            self.gru_b = nn.Parameter(torch.empty(8))
            self.gru_const = nn.Parameter(torch.empty(1, 1, cfg.num_heads, 1))
        self.ln1 = Norm(H, "layernorm")
        self.ff1 = Linear(H, cfg.intermediate_size, True)
        self.ff2 = Linear(cfg.intermediate_size, H, True)
        self.ln2 = Norm(H, "layernorm")


class WavLM(nn.Module):
    """The tower's weights; :func:`apply_wavlm` runs it."""

    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        H, g = cfg.hidden_size, cfg.num_conv_pos_embedding_groups
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.proj_ln = Norm(cfg.conv_dim[-1], "layernorm")
        self.proj = Linear(cfg.conv_dim[-1], H, True)
        self.pos_conv = Conv1d(H // g, H, cfg.num_conv_pos_embeddings)
        self.encoder_ln = Norm(H, "layernorm")
        if cfg.gated_rel_pos:
            self.rel_attn_embed = nn.Parameter(
                torch.empty(cfg.num_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(_Layer(cfg)
                                    for _ in range(cfg.num_layers))


# ----------------------------------------------------------------------- #
# Functions
# ----------------------------------------------------------------------- #


def _ln(x, p: Norm, eps: float):
    return _norm(x, p, "layernorm", eps)


def _gelu(x):
    return F.gelu(x, approximate="none")


def _feature_extractor(model: _FeatureExtractor, sig: torch.Tensor):
    """``[B, T]`` waveform → ``[B, N, conv_dim[-1]]``."""
    x = sig[:, None, :]
    for p in model.conv_layers:
        x = conv1d(x, p.w, p.b, stride=p.stride)
        if p.norm == "gn":
            mean = torch.mean(x, dim=-1, keepdim=True)
            var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            x = x * p.gn.g[:, None] + p.gn.b[:, None]
        elif p.norm == "ln":
            x = _ln(x.transpose(1, 2), p.ln, 1e-5).transpose(1, 2)
        x = _gelu(x)
    return x.transpose(1, 2)


@functools.lru_cache(maxsize=16)
def rel_pos_buckets(q_len: int, k_len: int, num_buckets: int,
                    max_distance: int) -> np.ndarray:
    """The T5-style log-bucketed relative positions ``[q_len, k_len]``
    (int64), in float64 numpy as the reference computes them."""
    half = num_buckets // 2
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    large = (max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                          / math.log(max_distance / max_exact)
                          * (half - max_exact))).astype(np.int64)
    large = np.minimum(large, half - 1)
    return buckets + np.where(rel < max_exact, rel, large)


def _attention(x, p: _Layer, cfg: WavLMConfig, position_bias):
    """Attention on (already normed, in pre-norm) ``x`` [B, T, H];
    ``position_bias`` [H, T, T] (ungated), or None for plain attention."""
    B, T, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    mask = None
    if position_bias is not None:
        # the GRU-style gate over the head-split states: an 8-wide linear,
        # summed in pairs of 4
        with exact_fp32():
            proj = torch.matmul(x.reshape(B, T, H, D), p.gru_w) + p.gru_b
        gate_a, gate_b = torch.sigmoid(
            proj.reshape(B, T, H, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = gate_a * (gate_b * p.gru_const - 1.0) + 2.0  # [B, T, H, 1]
        mask = (gate.permute(0, 2, 1, 3) * position_bias[None])[:, :, None]
    q = _linear(x, p.q).reshape(B, T, H, D) * D ** -0.5
    k = _linear(x, p.k).reshape(B, T, H, D)
    v = _linear(x, p.v).reshape(B, T, H, D)
    a = attention(q, k, v, mask, scale=1.0)
    return _linear(a.reshape(B, T, H * D), p.o)


def _ffn(x, p: _Layer):
    return _linear(_gelu(_linear(x, p.ff1)), p.ff2)


def _layer(x, p: _Layer, cfg: WavLMConfig, position_bias):
    """One layer: pre-norm (stable layer norm) or post-norm."""
    eps = cfg.layer_norm_eps
    if cfg.do_stable_layer_norm:
        x = x + _attention(_ln(x, p.ln1, eps), p, cfg, position_bias)
        return x + _ffn(_ln(x, p.ln2, eps), p)
    x = _ln(x + _attention(x, p, cfg, position_bias), p.ln1, eps)
    return _ln(x + _ffn(x, p), p.ln2, eps)


def apply_wavlm(model: WavLM, sig: torch.Tensor, cfg: WavLMConfig,
                output_layer: int | None = None,
                output_hidden_states: bool = False,
                final_ln_tap: bool = True) -> torch.Tensor:
    """``[B, T]`` waveform → the final hidden states ``[B, N, hidden]``.

    ``output_layer`` ``i`` returns the output of layer ``i`` (0: the
    input to the first) and runs no layer past it; ``output_hidden_states``
    stacks every state computed, ``[L + 1, B, N, hidden]``. In a
    stable-layer-norm config the encoder's final LayerNorm is applied to
    the last state when the tower ran to full depth and ``final_ln_tap``
    (HF's ``hidden_states``), and to the output when neither option is
    given. ``final_ln_tap=False`` keeps a full-depth tap un-normed, as the
    interior state of a deeper model (FocalCodec's 6 layers of 24)."""
    eps = cfg.layer_norm_eps
    x = _feature_extractor(model.feature_extractor, sig)
    x = _linear(_ln(x, model.proj_ln, eps), model.proj)
    pad = cfg.num_conv_pos_embeddings // 2
    pos = conv1d(F.pad(x.transpose(1, 2), (pad, pad)), model.pos_conv.w,
                 model.pos_conv.b, groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[..., :-1]
    x = x + _gelu(pos.transpose(1, 2))
    if not cfg.do_stable_layer_norm:
        x = _ln(x, model.encoder_ln, eps)

    position_bias = None
    if cfg.gated_rel_pos:
        T = x.shape[1]
        idx = torch.from_numpy(rel_pos_buckets(
            T, T, cfg.num_buckets, cfg.max_distance)).to(x.device)
        position_bias = model.rel_attn_embed[idx].permute(2, 0, 1)

    hidden = [x]
    for p in model.layers:
        x = _layer(x, p, cfg, position_bias)
        hidden.append(x)
        if output_layer is not None and len(hidden) - 1 == output_layer:
            break
    full_depth = len(hidden) - 1 == cfg.num_layers
    if cfg.do_stable_layer_norm and final_ln_tap and full_depth:
        hidden[-1] = x = _ln(hidden[-1], model.encoder_ln, eps)
    elif (cfg.do_stable_layer_norm and output_layer is None
          and not output_hidden_states):
        x = _ln(x, model.encoder_ln, eps)
    if output_hidden_states:
        return torch.stack(hidden)
    if output_layer is not None:
        return hidden[output_layer]
    return x


def init_wavlm_params(generator: torch.Generator, cfg: WavLMConfig,
                      prefix: str = "") -> dict:
    """Random weights of :class:`WavLM` as a flat state dict under
    ``prefix``, in the reference's distributions (``_init_wavlm_params``:
    linears N(0, 1/in) with zero biases, convs N(0, 1/(k·cin)), the
    positional conv N(0, 0.01²), the gate N(0, 1/head_dim) with constant 1,
    the bucket embeddings N(0, 0.02²), norms 1 and 0); the draws differ
    from the reference's."""
    H, D, g = cfg.hidden_size, cfg.head_dim, cfg.num_conv_pos_embedding_groups
    out = {}

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator) * scale

    def lin(name, i, o):
        out[f"{prefix}{name}.w"] = randn(i, o, scale=i ** -0.5)
        out[f"{prefix}{name}.b"] = torch.zeros(o)

    def norm(name, d):
        out[f"{prefix}{name}.g"] = torch.ones(d)
        out[f"{prefix}{name}.b"] = torch.zeros(d)

    cin = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p = f"feature_extractor.conv_layers.{i}"
        out[f"{prefix}{p}.w"] = randn(c, cin, k, scale=(cin * k) ** -0.5)
        if cfg.conv_bias:
            out[f"{prefix}{p}.b"] = torch.zeros(c)
        if cfg.feat_extract_norm == "layer":
            norm(f"{p}.ln", c)
        elif i == 0:
            norm(f"{p}.gn", c)
        cin = c
    norm("proj_ln", cfg.conv_dim[-1])
    lin("proj", cfg.conv_dim[-1], H)
    out[f"{prefix}pos_conv.w"] = randn(H, H // g, cfg.num_conv_pos_embeddings,
                                       scale=0.01)
    out[f"{prefix}pos_conv.b"] = torch.zeros(H)
    norm("encoder_ln", H)
    if cfg.gated_rel_pos:
        out[f"{prefix}rel_attn_embed"] = randn(cfg.num_buckets,
                                               cfg.num_heads, scale=0.02)
    for li in range(cfg.num_layers):
        p = f"layers.{li}"
        for name in ("q", "k", "v", "o"):
            lin(f"{p}.{name}", H, H)
        if cfg.gated_rel_pos:
            out[f"{prefix}{p}.gru_w"] = randn(D, 8, scale=D ** -0.5)
            out[f"{prefix}{p}.gru_b"] = torch.zeros(8)
            out[f"{prefix}{p}.gru_const"] = torch.ones(1, 1, cfg.num_heads, 1)
        norm(f"{p}.ln1", H)
        lin(f"{p}.ff1", H, cfg.intermediate_size)
        lin(f"{p}.ff2", cfg.intermediate_size, H)
        norm(f"{p}.ln2", H)
    return out
