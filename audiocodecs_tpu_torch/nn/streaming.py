"""Streaming (chunked-causal) primitives with carried state.

Counterpart of ``audiocodecs_tpu/nn/streaming.py``. State is an explicit
dict of tensors (or a tensor) that each call takes and returns:

* causal conv: the last ``padding_total`` input samples, ``[B, Cin, ctx]``;
* causal transposed conv (full right trim): the ``K − stride`` output tail,
  ``[B, Cout, K − stride]``, added into the next chunk's head; the bias goes
  on after the overlap-add, so it is not counted twice;
* transformer: each layer's rolling K/V window of the last ``window``
  positions, ``[layers, B, W, Hkv, D]``, the absolute position of each slot
  (−1 for an empty slot) and the next absolute position, a Python int.

Chunk lengths must be multiples of the layer stride (no frame-boundary
repadding mid-stream). The convs are library calls in full fp32, as the
reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from audiocodecs_tpu_torch.nn.layers import conv1d, conv_transpose1d
from audiocodecs_tpu_torch.nn.transformer import (
    Transformer,
    TransformerConfig,
    _additive,
    _norm,
    apply_layer,
    rope_cos_sin,
)

__all__ = ["apply_transformer_streaming", "conv_stream", "convtr_stream",
           "init_conv_state", "init_convtr_state",
           "init_transformer_stream_state"]


def init_conv_state(batch: int, kernel: int, stride: int, cin: int,
                    dilation: int = 1, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    eff_k = (kernel - 1) * dilation + 1
    return torch.zeros((batch, cin, eff_k - stride), dtype=dtype,
                       device=device)


def conv_stream(x, state, w, b=None, *, stride: int = 1, dilation: int = 1):
    """Causal conv over one chunk. ``x``: [B, Cin, L] with L % stride == 0;
    ``w``: [Cout, Cin, K] → (y [B, Cout, L / stride], new state)."""
    xc = torch.cat([state, x], dim=-1)
    y = conv1d(xc, w, b, stride=stride, dilation=dilation)
    ctx = state.shape[-1]
    return y, (xc[..., xc.shape[-1] - ctx:] if ctx else state)


def init_convtr_state(batch: int, kernel: int, stride: int, cout: int,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((batch, cout, kernel - stride), dtype=dtype,
                       device=device)


def convtr_stream(x, state, w, b=None, *, stride: int, groups: int = 1):
    """Causal transposed conv over one chunk (full right trim).

    ``x``: [B, Cin, L]; ``w``: [Cin, Cout/groups, K] → (y [B, Cout,
    L·stride], the K − stride output tail for the next chunk)."""
    L = x.shape[-1]
    y_full = conv_transpose1d(x, w, None, stride=stride, groups=groups)
    # full length = (L-1)*stride + K = L*stride + (K - stride)
    main, tail = y_full[..., : L * stride], y_full[..., L * stride:]
    overlap = state.shape[-1]
    if overlap:
        main = torch.cat([main[..., :overlap] + state, main[..., overlap:]],
                         dim=-1)
    if b is not None:
        main = main + b[:, None]
    return main, tail


def init_transformer_stream_state(cfg: TransformerConfig, batch: int,
                                  window: Optional[int] = None, device=None,
                                  dtype=torch.float32) -> dict:
    W = window or cfg.sliding_window or 512
    shape = (cfg.num_layers, batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((W,), -1, dtype=torch.int64, device=device),
        "pos": 0,
    }


def apply_transformer_streaming(model: Transformer, x: torch.Tensor,
                                cfg: TransformerConfig, state: dict):
    """One chunk ``[B, L, hidden]`` with the rolling sliding-window K/V
    state → (y, new state)."""
    L = x.shape[1]
    W = state["k"].shape[2]
    pos0 = state["pos"]
    positions = torch.arange(pos0, pos0 + L, device=x.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    q_pos = positions[:, None]  # [L, 1]
    kv_pos = torch.cat([state["slot_pos"][None, :].expand(L, W),
                        positions[None, :].expand(L, L)], dim=1)  # [L, W+L]
    ok = (kv_pos >= 0) & (kv_pos <= q_pos)
    if cfg.sliding_window is not None:
        ok &= kv_pos > q_pos - cfg.sliding_window
    mask = _additive(ok)[None, None, None]

    new_k, new_v = [], []
    for li, p in enumerate(model.layers):
        x, k_all, v_all = apply_layer(
            x, p, cfg, cos, sin, mask, kv=(state["k"][li], state["v"][li]))
        new_k.append(k_all[:, -W:])
        new_v.append(v_all[:, -W:])
    new_state = {
        "k": torch.stack(new_k),
        "v": torch.stack(new_v),
        "slot_pos": torch.cat([state["slot_pos"], positions])[-W:],
        "pos": pos0 + L,
    }
    if model.final_norm is not None:
        x = _norm(x, model.final_norm, cfg.norm, cfg.norm_eps)
    return x, new_state
