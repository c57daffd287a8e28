"""HF ``GPT2LMHeadModel`` checkpoint → the port's :class:`..nn.gpt2.GPT2`.

Counterpart of ``audiocodecs_tpu/convert/gpt2.py``. HF stores GPT-2's
projections as ``Conv1D`` with weight ``[in, out]``, the port's layout
already, so nothing is transposed. ``lm_head`` must equal ``wte`` (the tied
head) and is dropped. Strict: a checkpoint key it does not read raises
(the attention mask buffers aside).
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_norm,
    to_np,
)
from audiocodecs_tpu_torch.convert.zoo import _TrackingDict
from audiocodecs_tpu_torch.nn.gpt2 import GPT2Config

__all__ = ["convert_gpt2_state_dict", "gpt2_config_from_hf"]


def gpt2_config_from_hf(hf) -> GPT2Config:
    """The config of any object with the attribute names of HF's
    ``GPT2Config``."""
    return GPT2Config.from_hf_dict(
        {v: getattr(hf, v) for v in GPT2Config._HF_FIELDS.values()})


def convert_gpt2_state_dict(sd, cfg: GPT2Config) -> dict:
    """An HF GPT-2 state dict → :class:`..nn.gpt2.GPT2`'s."""
    sd = _TrackingDict(sd)
    out = {}

    def lin(dst, src):
        out[f"{dst}.w"] = to_np(sd[f"{src}.weight"]).astype(np.float32)
        out[f"{dst}.b"] = to_np(sd[f"{src}.bias"]).astype(np.float32)

    out["wte"] = to_np(sd["transformer.wte.weight"]).astype(np.float32)
    out["wpe"] = to_np(sd["transformer.wpe.weight"]).astype(np.float32)
    for i in range(cfg.n_layer):
        src, dst = f"transformer.h.{i}", f"layers.{i}"
        put_norm(out, f"{dst}.ln1", sd, f"{src}.ln_1")
        lin(f"{dst}.attn.qkv", f"{src}.attn.c_attn")
        lin(f"{dst}.attn.o", f"{src}.attn.c_proj")
        put_norm(out, f"{dst}.ln2", sd, f"{src}.ln_2")
        lin(f"{dst}.mlp.fc1", f"{src}.mlp.c_fc")
        lin(f"{dst}.mlp.fc2", f"{src}.mlp.c_proj")
    put_norm(out, "ln_f", sd, "transformer.ln_f")
    # lm_head is tied to wte (HF keeps a copy in the state dict)
    if "lm_head.weight" in sd:
        tied = to_np(sd["lm_head.weight"]).astype(np.float32)
        if not np.array_equal(tied, out["wte"]):
            raise ValueError("lm_head is not tied to wte — untied GPT-2 "
                             "heads are not supported")
    unused = sorted(k for k in sd if k not in sd.read
                    and not k.endswith((".attn.bias", ".attn.masked_bias")))
    if unused:
        raise ValueError(f"unmapped GPT-2 checkpoint keys: {unused[:8]}"
                         f" (+{max(0, len(unused) - 8)} more)")
    return as_state_dict(out)
