"""Weight bridge to and from the reference package's param trees.

:func:`from_jax_params` takes the JAX package's param tree, with numpy
arrays as leaves (``jax.tree.map(np.asarray, params)``), and returns the
state dict of a port module, ready for ``load_state_dict(strict=True)``.
:func:`to_jax_params` is its inverse: a port state dict back to the
reference's tree of numpy arrays, so that a model trained here is a
checkpoint of the JAX package (:mod:`.utils.checkpoint` writes it).
Nothing here imports JAX: the tree is plain dicts, lists and arrays.

Layouts (reference → port):

* conv ``w [K, Cin, Cout]`` → ``[Cout, Cin, K]``, for every
  :class:`~audiocodecs_tpu_torch.nn.layers.Conv1d`: the SEANet stacks, the
  Vocos head's embed ``[7, Cin, dim]`` → ``[dim, Cin, 7]`` and depthwise
  ``dwconv`` ``[7, 1, dim]`` → ``[dim, 1, 7]`` (groups = dim), and the
  SEANet-RVQ projectors ``in_proj`` ``[1, H, D]`` → ``[D, H, 1]`` and
  ``out_proj`` ``[1, D, H]`` → ``[H, D, 1]``, the WavLM tower's feature
  extractor ``[k, Cin, C]`` and its 16-group positional conv ``pos_conv``
  ``[128, H/16, H]`` → ``[H, H/16, 128]``, FocalNet's depthwise
  ``focal_convs`` ``[k, 1, C]`` and ECAPA's convs; and a bare conv leaf that
  a module lists in ``JAX_CONV_LEAVES`` (w2v-BERT's depthwise ``conv.dw``
  ``[31, 1, C]`` → ``[C, 1, 31]``);
* 2-D conv ``w [kh, kw, Cin, Cout]`` (HWIO) → ``[Cout, Cin, kh, kw]``
  (OIHW), for every :class:`~audiocodecs_tpu_torch.nn.layers.Conv2d`: the
  LDM VAE's and UNet's convs, their 1×1 projections included;
* transposed-conv ``w [K, Cin/G, Cout]`` with G groups, stored pre-flipped
  so that it runs as a plain dilated conv → ``[Cin, Cout/G, K]``, PyTorch's
  ``ConvTranspose1d`` layout: flipped in time, and input channel
  ``g·Cin/G + i`` to output ``g·Cout/G + j`` moved from ``[:, i, g·Cout/G +
  j]`` to ``[g·Cin/G + i, j, :]`` (for G = 1, ``flip(w, 0).permute(1, 2,
  0)``);
* LSTM ``w_ih [Cin, 4H]``, ``w_hh [H, 4H]``, summed ``b [4H]``: unchanged
  (gate order i, f, g, o), in each direction of a bidirectional layer too
  (``<layer>.fwd.w_ih`` …);
* transformer and Vocos linears ``w [in, out]`` (``pw1``, ``pw2``,
  ``head``: the port multiplies ``x @ w`` too), norm gains and biases,
  LayerScale vectors and the Vocos ``gamma``, AdaLN tables ``scale``/
  ``shift [n, dim]`` and continuous AdaLN ``scale_w``/``shift_w
  [cond_dim, dim]`` with their biases: unchanged;
* codebooks ``[K, C, H]``, quantizer projections and biases: unchanged;
* snake ``α``: ``[C]``, or ``[1, 1, C]`` where the reference keeps it so
  (BigCodec, X-Codec 2.0's encoder, BiCodec's generator): flattened here,
  and restored by :func:`to_jax_params` for a model whose class sets
  ``JAX_ALPHA_SHAPE``;
* a 0-d leaf (DyCAST's boundary bias, SemantiCodec's ``latent_scale``)
  stays 0-d.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from audiocodecs_tpu_torch.nn.layers import Conv1d, Conv2d, ConvTranspose1d

__all__ = ["flatten_tree", "from_jax_params", "to_jax_params"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists → ``{"encoder.1.block.0.w": array, ...}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _to_port_layout(owner: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "w" and isinstance(owner, ConvTranspose1d):
        k, cin_g, cout = a.shape
        g = owner.groups
        a = np.flip(a, 0).reshape(k, cin_g, g, cout // g)
        return a.transpose(2, 1, 3, 0).reshape(g * cin_g, cout // g, k)
    if leaf == "w" and isinstance(owner, Conv2d):
        return a.transpose(3, 2, 0, 1)
    if leaf == "w" and isinstance(owner, Conv1d) or leaf in getattr(
            owner, "JAX_CONV_LEAVES", ()):
        return a.transpose(2, 1, 0)
    if leaf.startswith("alpha") and a.ndim == 3 and a.shape[:2] == (1, 1):
        return a.reshape(-1)
    return a


def from_jax_params(tree, model: nn.Module) -> dict:
    """The reference tree as ``model``'s state dict (float32 tensors on the
    CPU). Raises on a missing or extra key or a shape mismatch."""
    flat = flatten_tree(tree)
    want = model.state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"param tree does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    out = {}
    for key, ref in want.items():
        owner_name, _, leaf = key.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        a = _to_port_layout(owner, leaf, np.asarray(flat[key]))
        t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        if t.shape != ref.shape:
            raise ValueError(f"{key}: converted shape {tuple(t.shape)} != "
                             f"model shape {tuple(ref.shape)}")
        out[key] = t
    return out


def _to_jax_layout(owner: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_to_port_layout`."""
    if leaf == "w" and isinstance(owner, ConvTranspose1d):
        cin, cout_g, k = a.shape
        g = owner.groups
        a = a.reshape(g, cin // g, cout_g, k).transpose(3, 1, 0, 2)
        return np.flip(a.reshape(k, cin // g, g * cout_g), 0)
    if leaf == "w" and isinstance(owner, Conv2d):
        return a.transpose(2, 3, 1, 0)
    if leaf == "w" and isinstance(owner, Conv1d) or leaf in getattr(
            owner, "JAX_CONV_LEAVES", ()):
        return a.transpose(2, 1, 0)
    return a


def to_jax_params(state_dict: dict, model: nn.Module):
    """``model``'s state dict (tensors on any device) as the reference's
    param tree: nested dicts keyed by module and parameter name, a list
    where the port has an ``nn.ModuleList`` (LSTM layers, a residual
    block's convs), and float32 numpy arrays in the reference's layouts.
    ``from_jax_params(to_jax_params(sd, model), model)`` gives ``sd`` back.
    Raises on a missing or extra key."""
    want = model.state_dict()
    alpha_shape = getattr(model, "JAX_ALPHA_SHAPE", None)
    missing = sorted(set(want) - set(state_dict))
    extra = sorted(set(state_dict) - set(want))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")

    def tree(module: nn.Module, prefix: str):
        node = {}
        own = [*module.named_parameters(recurse=False),
               *module.named_buffers(recurse=False)]
        for name in (n for n, _ in own if prefix + n in want):
            t = state_dict[prefix + name].detach().to("cpu", torch.float32)
            a = _to_jax_layout(module, name, t.numpy())
            if alpha_shape is not None and name.startswith("alpha"):
                a = a.reshape(alpha_shape)
            # (``ascontiguousarray`` makes a 0-d leaf 1-d)
            node[name] = np.ascontiguousarray(a).reshape(a.shape)
        for name, child in module.named_children():
            sub = tree(child, f"{prefix}{name}.")
            if sub or isinstance(module, nn.ModuleList):
                node[name] = sub
        if isinstance(module, nn.ModuleList):
            return [node[str(i)] for i in range(len(module))]
        return node

    return tree(model, "")
