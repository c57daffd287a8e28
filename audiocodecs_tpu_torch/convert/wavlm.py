"""HF WavLM / wav2vec2 checkpoint → the port's :class:`..nn.wavlm.WavLM`.

Counterpart of ``audiocodecs_tpu/convert/wavlm.py``. The feature
extractor's convs keep their layout; its norms (a GroupNorm after conv 0 in
the base form, a LayerNorm after each conv in the large one) become ``gn``
or ``ln``. The positional conv carries weight norm over dim 2 of its
``[H, H/G, K]`` weight (``weight_norm(dim=2)``): the fold reduces over
axes (0, 1), one norm per kernel position, not the conv fold of
:func:`.torch_utils.conv_weight`. WavLM's gated relative position brings
each layer's ``gru_rel_pos_linear`` and ``gru_rel_pos_const`` (as ``[1, 1,
heads, 1]``), and layer 0's ``rel_attn_embed``, which the port keeps once.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    fold_weight_norm_np,
    put_linear,
    put_norm,
    to_np,
)
from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig

__all__ = ["convert_wavlm_state_dict", "wavlm_config_from_hf",
           "wav2vec2_config_from_hf"]


def _common(hf) -> dict:
    return dict(
        hidden_size=hf.hidden_size,
        num_layers=hf.num_hidden_layers,
        num_heads=hf.num_attention_heads,
        intermediate_size=hf.intermediate_size,
        conv_dim=tuple(hf.conv_dim),
        conv_kernel=tuple(hf.conv_kernel),
        conv_stride=tuple(hf.conv_stride),
        conv_bias=hf.conv_bias,
        num_conv_pos_embeddings=hf.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=hf.num_conv_pos_embedding_groups,
        layer_norm_eps=hf.layer_norm_eps,
        do_stable_layer_norm=hf.do_stable_layer_norm,
        feat_extract_norm=hf.feat_extract_norm)


def wavlm_config_from_hf(hf) -> WavLMConfig:
    """The tower of any object with the attribute names of HF's
    ``WavLMConfig``."""
    return WavLMConfig(num_buckets=hf.num_buckets,
                       max_distance=hf.max_bucket_distance, **_common(hf))


def wav2vec2_config_from_hf(hf) -> WavLMConfig:
    """HF ``Wav2Vec2Config`` → the plain-attention tower variant."""
    return WavLMConfig(gated_rel_pos=False, **_common(hf))


def convert_wavlm_state_dict(sd, cfg: WavLMConfig, prefix: str = "") -> dict:
    """An HF WavLM or wav2vec2 state dict (its keys under ``prefix``) →
    :class:`WavLM`'s. Keys it does not read are ignored, as the reference
    ignores them."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out = {}
    for i in range(len(cfg.conv_kernel)):
        p = f"feature_extractor.conv_layers.{i}"  # the same in both
        out[f"{p}.w"] = to_np(sd[f"{p}.conv.weight"]).astype(np.float32)
        if f"{p}.conv.bias" in sd:
            out[f"{p}.b"] = to_np(sd[f"{p}.conv.bias"]).astype(np.float32)
        if f"{p}.layer_norm.weight" in sd:
            norm = "ln" if cfg.feat_extract_norm == "layer" else "gn"
            put_norm(out, f"{p}.{norm}", sd, f"{p}.layer_norm")

    pc = "encoder.pos_conv_embed.conv"
    if f"{pc}.parametrizations.weight.original0" in sd:
        g = sd[f"{pc}.parametrizations.weight.original0"]
        v = sd[f"{pc}.parametrizations.weight.original1"]
    else:
        g, v = sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"]
    out["pos_conv.w"] = fold_weight_norm_np(g, v, reduce_axes=(0, 1))
    out["pos_conv.b"] = to_np(sd[f"{pc}.bias"]).astype(np.float32)

    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        att = f"{src}.attention"
        for name, proj in (("q", "q_proj"), ("k", "k_proj"),
                           ("v", "v_proj"), ("o", "out_proj")):
            put_linear(out, f"{dst}.{name}", sd, f"{att}.{proj}")
        if cfg.gated_rel_pos:
            out[f"{dst}.gru_w"] = np.ascontiguousarray(
                to_np(sd[f"{att}.gru_rel_pos_linear.weight"]).T
                .astype(np.float32))
            out[f"{dst}.gru_b"] = to_np(
                sd[f"{att}.gru_rel_pos_linear.bias"]).astype(np.float32)
            out[f"{dst}.gru_const"] = to_np(
                sd[f"{att}.gru_rel_pos_const"]).reshape(
                    1, 1, cfg.num_heads, 1).astype(np.float32)
        put_norm(out, f"{dst}.ln1", sd, f"{src}.layer_norm")
        put_linear(out, f"{dst}.ff1", sd,
                   f"{src}.feed_forward.intermediate_dense")
        put_linear(out, f"{dst}.ff2", sd, f"{src}.feed_forward.output_dense")
        put_norm(out, f"{dst}.ln2", sd, f"{src}.final_layer_norm")

    put_norm(out, "proj_ln", sd, "feature_projection.layer_norm")
    put_linear(out, "proj", sd, "feature_projection.projection")
    put_norm(out, "encoder_ln", sd, "encoder.layer_norm")
    if cfg.gated_rel_pos:
        out["rel_attn_embed"] = to_np(
            sd["encoder.layers.0.attention.rel_attn_embed.weight"]).astype(
                np.float32)
    return as_state_dict(out)
