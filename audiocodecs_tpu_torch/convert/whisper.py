"""HF ``WhisperForConditionalGeneration`` checkpoint → the port's
:class:`..nn.whisper.Whisper`.

Counterpart of ``audiocodecs_tpu/convert/whisper.py``: linears
``[out, in]`` become ``w [in, out]``; the two stem convs keep PyTorch's
``[Cout, Cin, 3]``; ``proj_out`` must equal ``embed_tokens`` (the tied
head) and is dropped. Strict: a checkpoint key it does not read raises
(``position_ids`` buffers aside).
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_linear,
    put_norm,
    to_np,
)
from audiocodecs_tpu_torch.convert.zoo import _TrackingDict
from audiocodecs_tpu_torch.nn.whisper import WhisperConfig

__all__ = ["convert_whisper_state_dict", "whisper_config_from_hf"]


def whisper_config_from_hf(hf) -> WhisperConfig:
    """The config of any object with the attribute names of HF's
    ``WhisperConfig``."""
    return WhisperConfig.from_hf_dict(
        {v: getattr(hf, v) for v in WhisperConfig._HF_FIELDS.values()})


def _attn(out, sd, dst, src):
    for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                       ("o", "out_proj")):
        put_linear(out, f"{dst}.{name}", sd, f"{src}.{proj}")


def convert_whisper_state_dict(sd, cfg: WhisperConfig) -> dict:
    """An HF Whisper state dict → :class:`..nn.whisper.Whisper`'s."""
    sd = _TrackingDict(sd)
    out = {}
    for name in ("conv1", "conv2"):
        p = f"model.encoder.{name}"
        out[f"encoder.{name}.w"] = to_np(sd[f"{p}.weight"]).astype(
            np.float32)
        out[f"encoder.{name}.b"] = to_np(sd[f"{p}.bias"]).astype(np.float32)
    out["encoder.pos"] = to_np(
        sd["model.encoder.embed_positions.weight"]).astype(np.float32)
    for i in range(cfg.encoder_layers):
        src, dst = f"model.encoder.layers.{i}", f"encoder.layers.{i}"
        put_norm(out, f"{dst}.ln1", sd, f"{src}.self_attn_layer_norm")
        _attn(out, sd, f"{dst}.attn", f"{src}.self_attn")
        put_norm(out, f"{dst}.ln2", sd, f"{src}.final_layer_norm")
        put_linear(out, f"{dst}.mlp.fc1", sd, f"{src}.fc1")
        put_linear(out, f"{dst}.mlp.fc2", sd, f"{src}.fc2")
    put_norm(out, "encoder.ln_post", sd, "model.encoder.layer_norm")
    out["decoder.embed"] = to_np(
        sd["model.decoder.embed_tokens.weight"]).astype(np.float32)
    out["decoder.pos"] = to_np(
        sd["model.decoder.embed_positions.weight"]).astype(np.float32)
    for i in range(cfg.decoder_layers):
        src, dst = f"model.decoder.layers.{i}", f"decoder.layers.{i}"
        put_norm(out, f"{dst}.ln1", sd, f"{src}.self_attn_layer_norm")
        _attn(out, sd, f"{dst}.self_attn", f"{src}.self_attn")
        put_norm(out, f"{dst}.ln_x", sd, f"{src}.encoder_attn_layer_norm")
        _attn(out, sd, f"{dst}.cross_attn", f"{src}.encoder_attn")
        put_norm(out, f"{dst}.ln2", sd, f"{src}.final_layer_norm")
        put_linear(out, f"{dst}.mlp.fc1", sd, f"{src}.fc1")
        put_linear(out, f"{dst}.mlp.fc2", sd, f"{src}.fc2")
    put_norm(out, "decoder.ln_post", sd, "model.decoder.layer_norm")
    # proj_out is tied to embed_tokens (HF keeps a copy in some exports)
    if "proj_out.weight" in sd:
        tied = to_np(sd["proj_out.weight"]).astype(np.float32)
        if not np.array_equal(tied, out["decoder.embed"]):
            raise ValueError("proj_out is not tied to embed_tokens — "
                             "untied Whisper heads are not supported")
    unused = sorted(k for k in sd if k not in sd.read
                    and not k.endswith("position_ids"))
    if unused:
        raise ValueError(f"unmapped Whisper checkpoint keys: {unused[:8]}"
                         f" (+{max(0, len(unused) - 8)} more)")
    return as_state_dict(out)
