"""Checkpoint-conversion helpers: upstream PyTorch state dict → the port's.

Counterpart of ``audiocodecs_tpu/convert/torch_utils.py``. A converter
takes any mapping of name → torch tensor or numpy array and returns the
port model's own state dict: its ``state_dict()`` keys, float32 CPU
tensors. It is a direct mapping. Conv and transposed-conv weights keep
PyTorch's layouts (``[Cout, Cin, K]``, ``[Cin, Cout/G, K]``), as the port's
modules do; a tensor moves only where the port's layout differs:

* weight norm ``w = g · v / ‖v‖`` is folded, in float64, over every axis
  but dim 0 of the stored tensor (``weight_norm(dim=0)``, transposed convs
  included), from either naming: ``parametrizations.weight.original0/1``
  or the legacy ``weight_g``/``weight_v``;
* linear weights ``[out, in]`` are transposed to the port's ``[in, out]``
  (the port multiplies ``x @ w``); an LSTM's ``weight_ih``/``weight_hh`` to
  ``[Cin, 4H]``/``[H, 4H]``, and its two biases summed;
* codebooks are stacked to ``[K, C, H]`` and snake ``α`` ``[1, C, 1]``
  flattened to ``[C]``.

:func:`synth_state_dict` draws a seeded upstream-layout state dict from a
schema (key → shape), for running a full-width model without checkpoint
files.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "to_np",
    "to_tensor",
    "as_state_dict",
    "fold_weight_norm_np",
    "conv_weight",
    "put_conv",
    "put_alpha",
    "put_linear",
    "put_norm",
    "put_lstm",
    "wn_conv_schema",
    "lstm_schema",
    "synth_state_dict",
]


def to_np(x) -> np.ndarray:
    """torch.Tensor | np.ndarray | array-like → numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def to_tensor(a) -> torch.Tensor:
    """Array-like → a contiguous float32 CPU tensor."""
    return torch.from_numpy(np.array(to_np(a), dtype=np.float32, order="C"))


def as_state_dict(flat: dict) -> dict:
    """``{key: array}`` → ``{key: float32 CPU tensor}``."""
    return {k: to_tensor(v) for k, v in flat.items()}


def fold_weight_norm_np(g, v, reduce_axes=(1, 2)) -> np.ndarray:
    """w = g · v / ‖v‖ over ``reduce_axes``, computed in float64."""
    g = to_np(g).astype(np.float64)
    v = to_np(v).astype(np.float64)
    norm = np.sqrt((v**2).sum(axis=reduce_axes, keepdims=True))
    return (g * v / norm).astype(np.float32)


def conv_weight(sd, prefix: str) -> np.ndarray:
    """``{prefix}``'s weight in its stored layout, weight norm folded where
    the module carries it (either naming)."""
    if f"{prefix}.parametrizations.weight.original0" in sd:
        return fold_weight_norm_np(
            sd[f"{prefix}.parametrizations.weight.original0"],
            sd[f"{prefix}.parametrizations.weight.original1"])
    if f"{prefix}.weight_g" in sd:
        return fold_weight_norm_np(sd[f"{prefix}.weight_g"],
                                   sd[f"{prefix}.weight_v"])
    return to_np(sd[f"{prefix}.weight"]).astype(np.float32)


def put_conv(out: dict, dst: str, sd, prefix: str,
             bias: bool = True) -> np.ndarray:
    """A conv or transposed conv at ``prefix`` → ``dst.w`` in the stored
    layout, and ``{prefix}.bias`` → ``dst.b`` unless ``bias`` is False (a
    missing bias raises, as every missing key does). Returns the
    weight."""
    w = conv_weight(sd, prefix)
    out[f"{dst}.w"] = w
    if bias:
        out[f"{dst}.b"] = to_np(sd[f"{prefix}.bias"]).astype(np.float32)
    return w


def put_alpha(out: dict, dst: str, sd, key: str) -> None:
    """Snake's ``α`` ``[1, C, 1]`` at ``key`` → ``dst`` ``[C]``."""
    out[dst] = to_np(sd[key]).astype(np.float32).reshape(-1)


def put_linear(out: dict, dst: str, sd, prefix: str) -> None:
    """``{prefix}.weight [out, in]`` → ``dst.w [in, out]``; ``dst.b`` where
    the checkpoint has a bias."""
    w = to_np(sd[f"{prefix}.weight"]).astype(np.float32)
    out[f"{dst}.w"] = np.ascontiguousarray(w.T)
    if f"{prefix}.bias" in sd:
        out[f"{dst}.b"] = to_np(sd[f"{prefix}.bias"]).astype(np.float32)


def put_norm(out: dict, dst: str, sd, prefix: str) -> None:
    """A norm's ``weight``/``bias`` → ``dst.g``/``dst.b``."""
    out[f"{dst}.g"] = to_np(sd[f"{prefix}.weight"]).astype(np.float32)
    out[f"{dst}.b"] = to_np(sd[f"{prefix}.bias"]).astype(np.float32)


def put_lstm(out: dict, dst: str, sd, prefix: str, num_layers: int,
             directions=(("", ""),)) -> None:
    """``nn.LSTM`` at ``prefix`` → ``dst.<n>[.<tag>].{w_ih, w_hh, b}`` for
    each layer n and each (tag, key suffix) in ``directions``:
    ``(("", ""),)`` for one direction, ``(("fwd", ""), ("bwd",
    "_reverse"))`` for a bidirectional layer."""
    for n in range(num_layers):
        for tag, sfx in directions:
            d = f"{dst}.{n}.{tag}" if tag else f"{dst}.{n}"
            w_ih = to_np(sd[f"{prefix}.weight_ih_l{n}{sfx}"])
            w_hh = to_np(sd[f"{prefix}.weight_hh_l{n}{sfx}"])
            b_ih = to_np(sd[f"{prefix}.bias_ih_l{n}{sfx}"])
            b_hh = to_np(sd[f"{prefix}.bias_hh_l{n}{sfx}"])
            out[f"{d}.w_ih"] = np.ascontiguousarray(w_ih.T.astype(np.float32))
            out[f"{d}.w_hh"] = np.ascontiguousarray(w_hh.T.astype(np.float32))
            out[f"{d}.b"] = (b_ih.astype(np.float32)
                             + b_hh.astype(np.float32))


def wn_conv_schema(prefix: str, cout: int, cin: int, k: int,
                   transpose: bool = False,
                   parametrized: bool = False) -> dict:
    """A weight-normed conv's keys and shapes: ``v`` the stored weight
    (``[Cout, Cin, K]``, ``[Cin, Cout, K]`` transposed), ``g`` its dim 0;
    legacy ``weight_g``/``weight_v`` naming, or ``parametrizations.weight.
    original0/1`` with ``parametrized``."""
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    g, v = (("parametrizations.weight.original0",
             "parametrizations.weight.original1") if parametrized
            else ("weight_g", "weight_v"))
    return {f"{prefix}.{g}": (shape[0], 1, 1), f"{prefix}.{v}": shape,
            f"{prefix}.bias": (cout,)}


def lstm_schema(prefix: str, num_layers: int, hidden: int,
                bidirectional: bool = False) -> dict:
    """``nn.LSTM(hidden, hidden, num_layers)``'s keys and shapes (a
    bidirectional layer past the first reads ``2·hidden``)."""
    s = {}
    for n in range(num_layers):
        cin = 2 * hidden if bidirectional and n else hidden
        for sfx in ("", "_reverse") if bidirectional else ("",):
            s[f"{prefix}.weight_ih_l{n}{sfx}"] = (4 * hidden, cin)
            s[f"{prefix}.weight_hh_l{n}{sfx}"] = (4 * hidden, hidden)
            s[f"{prefix}.bias_ih_l{n}{sfx}"] = (4 * hidden,)
            s[f"{prefix}.bias_hh_l{n}{sfx}"] = (4 * hidden,)
    return s


_GAINS = ("weight_g", "original0", "alpha", "cluster_size", "cluster_usage")
_UNIT = ("weight_v", "original1", "embed", "embed_avg", "embed_sum")


def synth_state_dict(schema: dict, seed: int = 0) -> dict:
    """A seeded upstream-layout state dict (numpy float32) for ``schema``
    (key → shape) whose activations stay finite at any width: weight-norm
    gains, snake ``α``, 1-D norm weights and EMA counts in [0.5, 1.5]; the
    direction ``v``, codebooks and EMA sums N(0, 1); every other tensor of
    two or more axes N(0, 1/fan-in) (fan-in: the product of its axes but
    the first); biases N(0, 0.1²); ``inited`` ones."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in schema.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in _GAINS or (leaf == "weight" and len(shape) == 1):
            a = rng.random(shape, dtype=np.float32) + np.float32(0.5)
        elif leaf in ("inited", "initialized"):
            a = np.ones(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            if leaf in _UNIT or "codebook" in key:
                pass
            elif len(shape) >= 2:
                a *= np.float32(1.0 / math.sqrt(math.prod(shape[1:])))
            else:
                a *= np.float32(0.1)
        sd[key] = a
    return sd
