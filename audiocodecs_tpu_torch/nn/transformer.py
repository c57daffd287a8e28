"""Transformer blocks (pre-LN, RoPE, GQA, optional LayerScale and sliding
window).

Counterpart of ``audiocodecs_tpu/nn/transformer.py``. One implementation
serves the Mimi codec's encoder/decoder transformers (LayerNorm, LayerScale,
gelu MLP, sliding-window causal attention) and Llama-style stacks (RMSNorm,
SwiGLU, grouped-query attention).

Weights keep the reference's layout and names, so the weight bridge copies
them unchanged: a linear is ``w [in, out]`` (applied as ``x @ w``) with an
optional ``b``, a norm is ``g`` (and ``b`` for LayerNorm), and a layer's
state-dict keys read ``layers.<i>.q.w``, ``layers.<i>.mlp.fc1.w``,
``layers.<i>.scale_attn`` …

Attention is written as the reference writes it: two batched products in
full fp32 (:func:`..nn.layers.exact_fp32`), an additive mask and the softmax
in fp32. It does not call ``scaled_dot_product_attention``, which picks its
own backend and summation order; Mimi's tokens depend on this output.

Not ported: the reference's MoE FFN and rematerialization, which belong to
training and the parallel layer. A config that sets ``moe`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32

__all__ = ["TransformerConfig", "Transformer", "TransformerLayer",
           "apply_layer", "apply_rope", "apply_transformer", "attention",
           "causal_mask", "init_transformer_params", "rope_cos_sin"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    act: str = "gelu"  # "gelu" | "swiglu"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_layer_scale: bool = False
    sliding_window: Optional[int] = None
    attention_bias: bool = False
    causal: bool = True
    moe: Optional[object] = None

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError("the MoE FFN is not ported")
        if self.act not in ("gelu", "swiglu"):
            raise ValueError(f"unknown act {self.act!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")


# ----------------------------------------------------------------------- #
# Modules (weights only; the functions below apply them)
# ----------------------------------------------------------------------- #


class Linear(nn.Module):
    """``w`` [in, out] and an optional ``b`` [out]."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout))
        self.b = nn.Parameter(torch.empty(cout)) if bias else None


class Norm(nn.Module):
    """Gain ``g``, and bias ``b`` for LayerNorm."""

    def __init__(self, dim: int, kind: str):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))
        self.b = (nn.Parameter(torch.empty(dim)) if kind == "layernorm"
                  else None)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        H, inner = cfg.hidden_size, cfg.intermediate_size
        if cfg.act == "swiglu":
            self.gate, self.up = Linear(H, inner), Linear(H, inner)
            self.down = Linear(inner, H)
        else:
            self.fc1, self.fc2 = Linear(H, inner), Linear(inner, H)


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        H, D, bias = cfg.hidden_size, cfg.head_dim, cfg.attention_bias
        self.ln1 = Norm(H, cfg.norm)
        self.q = Linear(H, cfg.num_heads * D, bias)
        self.k = Linear(H, cfg.num_kv_heads * D, bias)
        self.v = Linear(H, cfg.num_kv_heads * D, bias)
        self.o = Linear(cfg.num_heads * D, H, bias)
        self.ln2 = Norm(H, cfg.norm)
        self.mlp = MLP(cfg)
        if cfg.use_layer_scale:
            self.scale_attn = nn.Parameter(torch.empty(H))
            self.scale_mlp = nn.Parameter(torch.empty(H))


class Transformer(nn.Module):
    """``layers.<i>`` and, with ``final_norm=True``, a closing norm.
    ``forward``: [B, T, hidden] → [B, T, hidden]."""

    def __init__(self, cfg: TransformerConfig, final_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            TransformerLayer(cfg) for _ in range(cfg.num_layers))
        self.final_norm = (Norm(cfg.hidden_size, cfg.norm) if final_norm
                           else None)

    def forward(self, x: torch.Tensor, positions=None) -> torch.Tensor:
        return apply_transformer(self, x, self.cfg, positions)


# ----------------------------------------------------------------------- #
# Functions
# ----------------------------------------------------------------------- #


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """``positions`` [T] → (cos, sin), each [T, head_dim] (halves
    duplicated)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x``: [B, T, H, D]; cos/sin: [T, D]."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return x * cos + _rotate_half(x) * sin


def causal_mask(q_len: int, kv_len: int, sliding_window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Additive mask [q_len, kv_len]; 0 where attendable, −inf elsewhere."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = k_pos <= q_pos
    if sliding_window is not None:
        ok &= k_pos > q_pos - sliding_window
    return _additive(ok)


def _additive(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, float("-inf"))


def attention(q, k, v, mask=None, scale=None, operand=None):
    """``q``: [B, T, Hq, D], ``k``/``v``: [B, S, Hkv, D] → [B, T, Hq, D].

    GQA by grouping the query heads; scores and softmax in float32. ``mask``
    broadcasts over scores [B, Hkv, G, T, S]. ``operand`` (a
    :meth:`..nn.layers.DecodeForm.operand`) maps each operand of the two
    products (q and k, then the probabilities and v) before it."""
    if operand is not None:
        q, k, v = operand(q), operand(k), operand(v)
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    groups = Hq // Hkv
    qg = q.reshape(B, T, Hkv, groups, D).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # [B, Hkv, 1, D, S]
    vt = v.permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, D]
    with exact_fp32():
        scores = torch.matmul(qg, kt).to(torch.float32) * scale
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        if operand is not None:
            probs = operand(probs)
        out = torch.matmul(probs, vt)  # [B, Hkv, G, T, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D)


def _norm(x, p: Norm, kind: str, eps: float):
    if kind == "rmsnorm":
        var = torch.mean(x.to(torch.float32) ** 2, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps).to(x.dtype) * p.g
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p.g + p.b


def _linear(x, p: Linear):
    with exact_fp32():
        y = torch.matmul(x, p.w)
    return y if p.b is None else y + p.b


def _mlp(x, p: MLP, act: str):
    if act == "swiglu":
        return _linear(F.silu(_linear(x, p.gate)) * _linear(x, p.up), p.down)
    return _linear(F.gelu(_linear(x, p.fc1)), p.fc2)


def apply_layer(x, p: TransformerLayer, cfg: TransformerConfig, cos, sin,
                mask, kv=None):
    """One pre-norm layer. With ``kv`` = (k_cache, v_cache) [B, W, Hkv, D],
    this chunk's keys and values attend after the cache's (streaming); the
    return is then (x, k_all, v_all)."""
    B, T, _ = x.shape
    h = _norm(x, p.ln1, cfg.norm, cfg.norm_eps)
    q = _linear(h, p.q).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = _linear(h, p.k).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(h, p.v).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if kv is not None:
        k = torch.cat([kv[0], k], dim=1)
        v = torch.cat([kv[1], v], dim=1)
    a = attention(q, k, v, mask)
    a = _linear(a.reshape(B, T, cfg.num_heads * cfg.head_dim), p.o)
    if cfg.use_layer_scale:
        a = a * p.scale_attn
    x = x + a
    m = _mlp(_norm(x, p.ln2, cfg.norm, cfg.norm_eps), p.mlp, cfg.act)
    if cfg.use_layer_scale:
        m = m * p.scale_mlp
    x = x + m
    return x if kv is None else (x, k, v)


def apply_transformer(model: Transformer, x: torch.Tensor,
                      cfg: TransformerConfig,
                      positions: Optional[torch.Tensor] = None):
    """``x``: [B, T, hidden] → [B, T, hidden] through ``model``'s layers
    (and its final norm, if it has one)."""
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    mask = (causal_mask(T, T, cfg.sliding_window, x.device)[None, None, None]
            if cfg.causal else None)
    for p in model.layers:
        x = apply_layer(x, p, cfg, cos, sin, mask)
    if model.final_norm is not None:
        x = _norm(x, model.final_norm, cfg.norm, cfg.norm_eps)
    return x


def init_transformer_params(generator: torch.Generator,
                            cfg: TransformerConfig, prefix: str = "") -> dict:
    """Flat state dict of a :class:`Transformer` (without final norm), in
    the reference package's distributions: linears N(0, 1/in), norms 1 and
    0, LayerScale 0.01 (the draws differ from ``jax.random``'s)."""
    out = {}
    H, D = cfg.hidden_size, cfg.head_dim

    def lin(name, i, o, bias):
        out[f"{name}.w"] = torch.randn(i, o, generator=generator) * i ** -0.5
        if bias:
            out[f"{name}.b"] = torch.zeros(o)

    def norm(name):
        out[f"{name}.g"] = torch.ones(H)
        if cfg.norm == "layernorm":
            out[f"{name}.b"] = torch.zeros(H)

    for li in range(cfg.num_layers):
        pre = f"{prefix}layers.{li}"
        bias = cfg.attention_bias
        norm(f"{pre}.ln1")
        lin(f"{pre}.q", H, cfg.num_heads * D, bias)
        lin(f"{pre}.k", H, cfg.num_kv_heads * D, bias)
        lin(f"{pre}.v", H, cfg.num_kv_heads * D, bias)
        lin(f"{pre}.o", cfg.num_heads * D, H, bias)
        norm(f"{pre}.ln2")
        inner = cfg.intermediate_size
        if cfg.act == "swiglu":
            lin(f"{pre}.mlp.gate", H, inner, False)
            lin(f"{pre}.mlp.up", H, inner, False)
            lin(f"{pre}.mlp.down", inner, H, False)
        else:
            lin(f"{pre}.mlp.fc1", H, inner, False)
            lin(f"{pre}.mlp.fc2", inner, H, False)
        if cfg.use_layer_scale:
            out[f"{pre}.scale_attn"] = torch.full((H,), 0.01)
            out[f"{pre}.scale_mlp"] = torch.full((H,), 0.01)
    return out
