"""AudioMAE (timm ViT) checkpoint → the port's :class:`..nn.audiomae.
AudioMAE`.

Counterpart of ``audiocodecs_tpu/convert/audiomae.py``. SemantiCodec's
released checkpoints carry the AudioMAE encoder in timm's vision-
transformer naming:

  patch_embed.proj.{weight,bias}     Conv2d(1, D, p, p), stride p
  cls_token                          [1, 1, D]
  pos_embed                          [1, 1 + P, D]
  blocks.<i>.norm1.{weight,bias}
  blocks.<i>.attn.qkv.{weight,bias}  fused [3D, D]
  blocks.<i>.attn.proj.{weight,bias}
  blocks.<i>.norm2.{weight,bias}
  blocks.<i>.mlp.fc1.{weight,bias}   [4D, D]
  blocks.<i>.mlp.fc2.{weight,bias}
  norm.{weight,bias}

The patch embedding (a conv whose stride is its kernel) becomes the port's
linear over flattened patches, ``[p², D]``; ``cls_token`` becomes ``[1,
D]`` and ``pos_embed`` ``[1 + P, D]``.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_linear,
    put_norm,
    to_np,
)
from audiocodecs_tpu_torch.nn.audiomae import AudioMAEConfig

__all__ = ["convert_audiomae_state_dict", "audiomae_schema"]


def convert_audiomae_state_dict(sd, cfg: AudioMAEConfig,
                                prefix: str = "") -> dict:
    """The encoder's keys under ``prefix`` (for one nested in a larger
    checkpoint) → :class:`AudioMAE`'s state dict."""
    p = prefix
    w = to_np(sd[f"{p}patch_embed.proj.weight"]).astype(np.float32)
    D = w.shape[0]
    out = {"patch_embed.w": np.ascontiguousarray(w.reshape(D, -1).T),
           "patch_embed.b": to_np(sd[f"{p}patch_embed.proj.bias"]).astype(
               np.float32),
           "cls_token": to_np(sd[f"{p}cls_token"]).astype(
               np.float32).reshape(1, D),
           "pos_embed": to_np(sd[f"{p}pos_embed"]).astype(np.float32)[0]}
    put_norm(out, "norm", sd, f"{p}norm")
    for i in range(cfg.num_layers):
        b, d = f"{p}blocks.{i}", f"blocks.{i}"
        put_norm(out, f"{d}.norm1", sd, f"{b}.norm1")
        put_linear(out, f"{d}.attn.qkv", sd, f"{b}.attn.qkv")
        put_linear(out, f"{d}.attn.proj", sd, f"{b}.attn.proj")
        put_norm(out, f"{d}.norm2", sd, f"{b}.norm2")
        put_linear(out, f"{d}.mlp.fc1", sd, f"{b}.mlp.fc1")
        put_linear(out, f"{d}.mlp.fc2", sd, f"{b}.mlp.fc2")
    return as_state_dict(out)


def audiomae_schema(cfg: AudioMAEConfig, prefix: str = "") -> dict:
    D, p = cfg.hidden_size, prefix
    hidden = int(D * cfg.mlp_ratio)
    s = {f"{p}patch_embed.proj.weight": (D, 1, cfg.patch_size,
                                         cfg.patch_size),
         f"{p}patch_embed.proj.bias": (D,),
         f"{p}cls_token": (1, 1, D),
         f"{p}pos_embed": (1, cfg.num_patches + 1, D),
         f"{p}norm.weight": (D,), f"{p}norm.bias": (D,)}
    for i in range(cfg.num_layers):
        b = f"{p}blocks.{i}"
        for name, o, n_in in (("attn.qkv", 3 * D, D), ("attn.proj", D, D),
                              ("mlp.fc1", hidden, D), ("mlp.fc2", D, hidden)):
            s[f"{b}.{name}.weight"] = (o, n_in)
            s[f"{b}.{name}.bias"] = (o,)
        for ln in ("norm1", "norm2"):
            s[f"{b}.{ln}.weight"] = (D,)
            s[f"{b}.{ln}.bias"] = (D,)
    return s
