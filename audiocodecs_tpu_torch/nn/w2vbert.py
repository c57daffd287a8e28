"""Wav2Vec2-BERT (w2v-bert-2.0) conformer encoder, PyTorch.

Counterpart of ``audiocodecs_tpu/nn/w2vbert.py``: X-Codec 2.0's semantic
branch, which taps hidden state 16 of ``facebook/w2v-bert-2.0`` (hidden
1024, 24 conformer layers, 16 heads, FFN 4096, relative-key positions).

* :func:`w2vbert_features`: HF ``SeamlessM4TFeatureExtractor``'s front end
  (kaldi fbank with the povey window on the 2¹⁵-scaled waveform, 80 bins;
  per-bin normalisation over the utterance with ddof = 1; stride-2 frame
  stacking to 160, an odd frame count padded with a zero frame);
* feature projection: LayerNorm over the 160 inputs, a 160 → 1024 linear;
* conformer layer: half-step FFN → self-attention with relative-key
  position scores (a [64 + 8 + 1, head_dim] distance table, offsets
  clamped to [−64, 8]) → conv module (pointwise → GLU → causal depthwise
  k31 → LayerNorm → swish → pointwise) → half-step FFN → LayerNorm.

:func:`apply_w2vbert` stops at ``output_layer`` as the reference does.
Weights keep the reference's names and layouts; the depthwise conv's
``conv.dw`` ``[K, 1, C]`` becomes ``[C, 1, K]`` in the weight bridge
(``JAX_CONV_LEAVES``). Every product runs in exact fp32 (TF32 off): these
features set X-Codec 2.0's tokens. The relative-key scores are ``q``
against the 73-row distance table, gathered at each pair's clamped offset,
rather than ``q`` against a gathered ``[T, T, D]`` table: the same dot
products, without the table.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.kaldi_fbank import kaldi_fbank
from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.nn.transformer import Linear, Norm, _linear, _norm

__all__ = ["W2VBertConfig", "W2VBert", "apply_w2vbert", "w2vbert_features",
           "init_w2vbert_params"]


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    input_dim: int = 160  # 80 mel bins × stride-2 stacking
    left_max_positions: int = 64
    right_max_positions: int = 8
    conv_kernel: int = 31
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_positions(self) -> int:
        return self.left_max_positions + self.right_max_positions + 1


def _ln(x, p: Norm, eps: float):
    return _norm(x, p, "layernorm", eps)


def w2vbert_features(sig: torch.Tensor, sample_rate: int = 16000
                     ) -> torch.Tensor:
    """``[B, T]`` waveform → ``[B, N, 160]`` stacked normalised log-mels."""
    mel = kaldi_fbank(sig * 32768.0, sample_rate, num_mel_bins=80,
                      window="povey")  # [B, F, 80]
    n = mel.shape[1]
    mean = torch.mean(mel, dim=1, keepdim=True)
    var = torch.sum((mel - mean) ** 2, dim=1, keepdim=True) / max(n - 1, 1)
    mel = (mel - mean) / torch.sqrt(var + 1e-7)
    if n % 2:
        mel = F.pad(mel, (0, 0, 0, 1))
        n += 1
    return mel.reshape(mel.shape[0], n // 2, 160)


class _Attention(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        C = cfg.hidden_size
        self.q, self.k = Linear(C, C, True), Linear(C, C, True)
        self.v, self.o = Linear(C, C, True), Linear(C, C, True)
        self.dist_emb = nn.Parameter(torch.empty(cfg.num_positions,
                                                 cfg.head_dim))


class _ConvModule(nn.Module):
    # leaves that are conv weights in the reference's [K, Cin, Cout] layout
    JAX_CONV_LEAVES = ("dw",)

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        C = cfg.hidden_size
        self.ln = Norm(C, "layernorm")
        self.pw1 = nn.Parameter(torch.empty(C, 2 * C))
        self.dw = nn.Parameter(torch.empty(C, 1, cfg.conv_kernel))
        self.dw_ln = Norm(C, "layernorm")
        self.pw2 = nn.Parameter(torch.empty(C, C))


def _ffn(C: int, inner: int) -> nn.ModuleDict:
    return nn.ModuleDict({"in": Linear(C, inner, True),
                          "out": Linear(inner, C, True)})


class _Layer(nn.Module):
    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        C, inner = cfg.hidden_size, cfg.intermediate_size
        self.ffn1_ln, self.ffn1 = Norm(C, "layernorm"), _ffn(C, inner)
        self.attn_ln, self.attn = Norm(C, "layernorm"), _Attention(cfg)
        self.conv = _ConvModule(cfg)
        self.ffn2_ln, self.ffn2 = Norm(C, "layernorm"), _ffn(C, inner)
        self.final_ln = Norm(C, "layernorm")


class W2VBert(nn.Module):
    """``proj_ln``, ``proj`` and ``layers.<i>``."""

    def __init__(self, cfg: W2VBertConfig):
        super().__init__()
        self.cfg = cfg
        self.proj_ln = Norm(cfg.input_dim, "layernorm")
        self.proj = Linear(cfg.input_dim, cfg.hidden_size, True)
        self.layers = nn.ModuleList(_Layer(cfg)
                                    for _ in range(cfg.num_layers))


def _ffn_apply(x, p: nn.ModuleDict):
    return _linear(F.silu(_linear(x, p["in"])), p["out"])


def _conv_module(x, p: _ConvModule, cfg: W2VBertConfig):
    """The conformer conv block on ``[B, T, C]``."""
    x = _ln(x, p.ln, cfg.layer_norm_eps)
    with exact_fp32():
        h = x @ p.pw1  # [B, T, 2C]
    a, b = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)).transpose(1, 2)  # GLU, [B, C, T]
    h = F.pad(h, (cfg.conv_kernel - 1, 0))  # causal
    with exact_fp32():
        h = F.conv1d(h, p.dw, groups=cfg.hidden_size).transpose(1, 2)
    h = F.silu(_ln(h, p.dw_ln, cfg.layer_norm_eps))
    with exact_fp32():
        return h @ p.pw2


def _attention(x, p: _Attention, cfg: W2VBertConfig, rel_idx):
    B, T, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim

    def heads(lin):  # [B, H, T, D]
        return _linear(x, lin).reshape(B, T, H, D).transpose(1, 2)

    q, k, v = heads(p.q), heads(p.k), heads(p.v)
    with exact_fp32():
        scores = torch.matmul(q, k.transpose(-1, -2))
        # relative-key scores: q against dist_emb[clamp(s − t)]
        qe = torch.matmul(q, p.dist_emb.T)  # [B, H, T, positions]
        rel = torch.gather(qe, -1, rel_idx.expand(B, H, T, T))
        probs = torch.softmax((scores + rel) * (D ** -0.5), dim=-1)
        a = torch.matmul(probs, v)  # [B, H, T, D]
    return _linear(a.transpose(1, 2).reshape(B, T, H * D), p.o)


def _layer(x, p: _Layer, cfg: W2VBertConfig, rel_idx):
    eps = cfg.layer_norm_eps
    x = _ffn_apply(_ln(x, p.ffn1_ln, eps), p.ffn1) * 0.5 + x
    x = _attention(_ln(x, p.attn_ln, eps), p.attn, cfg, rel_idx) + x
    x = x + _conv_module(x, p.conv, cfg)
    x = _ffn_apply(_ln(x, p.ffn2_ln, eps), p.ffn2) * 0.5 + x
    return _ln(x, p.final_ln, eps)


def apply_w2vbert(model: W2VBert, feats: torch.Tensor, cfg: W2VBertConfig,
                  output_layer: int | None = None,
                  output_hidden_states: bool = False) -> torch.Tensor:
    """``[B, N, input_dim]`` features → hidden states ``[B, N, hidden]``.

    ``output_layer`` indexes as HF ``hidden_states`` do: 0 is the feature
    projection's output, ``i`` the output of conformer layer ``i``; for
    ``i`` ≥ 1 the layers past it are not run. ``output_hidden_states``
    stacks every state computed."""
    x = _linear(_ln(feats, model.proj_ln, cfg.layer_norm_eps), model.proj)
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)
    dist = torch.clamp(pos[None, :] - pos[:, None],
                       -cfg.left_max_positions, cfg.right_max_positions)
    rel_idx = (dist + cfg.left_max_positions)[None, None]  # [1, 1, T, T]
    hidden = [x]
    for p in model.layers:
        x = _layer(x, p, cfg, rel_idx)
        hidden.append(x)
        if output_layer is not None and len(hidden) - 1 == output_layer:
            break
    if output_hidden_states:
        return torch.stack(hidden)
    if output_layer is not None:
        return hidden[output_layer]
    return x


def init_w2vbert_params(generator: torch.Generator, cfg: W2VBertConfig,
                        prefix: str = "") -> dict:
    """Random weights of :class:`W2VBert` as a flat state dict under
    ``prefix``, in the reference's distributions (linears N(0, 1/in) with
    zero biases, the distance table N(0, 0.02²), the depthwise conv
    N(0, 1/K)); the draws differ from ``jax.random``'s."""
    C, inner = cfg.hidden_size, cfg.intermediate_size
    out = {}

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator) * scale

    def lin(name, i, o):
        out[f"{name}.w"] = randn(i, o, scale=i ** -0.5)
        out[f"{name}.b"] = torch.zeros(o)

    def norm(name, dim=C):
        out[f"{name}.g"] = torch.ones(dim)
        out[f"{name}.b"] = torch.zeros(dim)

    norm(f"{prefix}proj_ln", cfg.input_dim)
    lin(f"{prefix}proj", cfg.input_dim, C)
    for li in range(cfg.num_layers):
        p = f"{prefix}layers.{li}"
        norm(f"{p}.ffn1_ln")
        lin(f"{p}.ffn1.in", C, inner)
        lin(f"{p}.ffn1.out", inner, C)
        norm(f"{p}.attn_ln")
        for name in ("q", "k", "v", "o"):
            lin(f"{p}.attn.{name}", C, C)
        out[f"{p}.attn.dist_emb"] = randn(cfg.num_positions, cfg.head_dim,
                                          scale=0.02)
        norm(f"{p}.conv.ln")
        out[f"{p}.conv.pw1"] = randn(C, 2 * C, scale=C ** -0.5)
        out[f"{p}.conv.dw"] = randn(C, 1, cfg.conv_kernel,
                                    scale=cfg.conv_kernel ** -0.5)
        norm(f"{p}.conv.dw_ln")
        out[f"{p}.conv.pw2"] = randn(C, C, scale=C ** -0.5)
        norm(f"{p}.ffn2_ln")
        lin(f"{p}.ffn2.in", C, inner)
        lin(f"{p}.ffn2.out", inner, C)
        norm(f"{p}.final_ln")
    return out
