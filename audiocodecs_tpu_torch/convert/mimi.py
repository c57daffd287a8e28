"""HF Mimi checkpoint → the port's :class:`..models.mimi.Mimi`.

Counterpart of ``audiocodecs_tpu/convert/mimi.py``. The SEANet stacks are
named as HF's EnCodec's (``{root}.layers.<i>``, no LSTM); each transformer
layer carries its two layer scales; each codebook is ``embed_sum /
max(cluster_usage, 1e-5)``, computed in float64. The grouped upsample
``ConvTranspose1d`` is stored ``[Cin, Cout/G, K]`` upstream and so in the
port: it is taken as it stands (the JAX package re-lays it out for
``lax``). The split RVQ's 1×1 ``input_proj``/``output_proj`` become
``[H, D]``/``[D, H]`` matrices.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    put_conv,
    put_linear,
    put_norm,
    to_np,
)
from audiocodecs_tpu_torch.models.mimi import MimiModelConfig
from audiocodecs_tpu_torch.nn.seanet import (
    seanet_decoder_plan,
    seanet_encoder_plan,
)

__all__ = ["convert_mimi_state_dict", "mimi_config_from_hf"]

_FIELDS = ("sampling_rate", "audio_channels", "num_filters", "hidden_size",
           "kernel_size", "last_kernel_size", "residual_kernel_size",
           "dilation_growth_rate", "num_residual_layers", "compress",
           "use_causal_conv", "pad_mode", "use_conv_shortcut",
           "trim_right_ratio", "num_hidden_layers", "num_attention_heads",
           "num_key_value_heads", "head_dim", "intermediate_size",
           "norm_eps", "rope_theta", "sliding_window",
           "layer_scale_initial_scale", "codebook_size", "codebook_dim",
           "num_quantizers", "num_semantic_quantizers", "frame_rate",
           "encodec_frame_rate", "upsample_groups")


def mimi_config_from_hf(hf) -> MimiModelConfig:
    """The architecture of any object with the attribute names of HF's
    ``MimiConfig``."""
    return MimiModelConfig(upsampling_ratios=tuple(hf.upsampling_ratios),
                           **{f: getattr(hf, f) for f in _FIELDS})


def _put_seanet(out, sd, plan, root: str, cfg: MimiModelConfig) -> None:
    for spec in plan:
        kind, idx = spec[0], spec[1]
        src, dst = f"{root}.layers.{idx}", f"{root}.{idx}"
        if kind in ("conv", "convtr"):
            put_conv(out, dst, sd, f"{src}.conv")
        elif kind == "resnet":
            put_conv(out, f"{dst}.block.0", sd, f"{src}.block.1.conv")
            put_conv(out, f"{dst}.block.1", sd, f"{src}.block.3.conv")
            if cfg.use_conv_shortcut:
                put_conv(out, f"{dst}.shortcut", sd, f"{src}.shortcut.conv")


def _put_transformer(out, sd, root: str, cfg: MimiModelConfig) -> None:
    for i in range(cfg.num_hidden_layers):
        src = dst = f"{root}.layers.{i}"
        put_norm(out, f"{dst}.ln1", sd, f"{src}.input_layernorm")
        for name, proj in (("q", "q_proj"), ("k", "k_proj"),
                           ("v", "v_proj"), ("o", "o_proj")):
            put_linear(out, f"{dst}.{name}", sd, f"{src}.self_attn.{proj}")
        put_norm(out, f"{dst}.ln2", sd, f"{src}.post_attention_layernorm")
        put_linear(out, f"{dst}.mlp.fc1", sd, f"{src}.mlp.fc1")
        put_linear(out, f"{dst}.mlp.fc2", sd, f"{src}.mlp.fc2")
        out[f"{dst}.scale_attn"] = to_np(
            sd[f"{src}.self_attn_layer_scale.scale"]).astype(np.float32)
        out[f"{dst}.scale_mlp"] = to_np(
            sd[f"{src}.mlp_layer_scale.scale"]).astype(np.float32)


def _put_rvq(out, sd, src: str, dst: str, n: int) -> None:
    cbs = []
    for k in range(n):
        p = f"{src}.layers.{k}.codebook"
        embed_sum = to_np(sd[f"{p}.embed_sum"]).astype(np.float64)
        usage = to_np(sd[f"{p}.cluster_usage"]).astype(np.float64)
        cbs.append((embed_sum / np.clip(usage, 1e-5, None)[:, None])
                   .astype(np.float32))
    out[f"{dst}.codebooks"] = np.stack(cbs)
    for name, proj in (("in_proj", "input_proj"), ("out_proj", "output_proj")):
        # a 1×1 conv without bias [Cout, Cin, 1] → [Cin, Cout]
        out[f"{dst}.{name}"] = np.ascontiguousarray(
            to_np(sd[f"{src}.{proj}.weight"])[:, :, 0].T.astype(np.float32))


def convert_mimi_state_dict(sd, cfg: MimiModelConfig) -> dict:
    """An HF Mimi state dict → :class:`Mimi`'s. Keys it does not read are
    ignored, as the reference ignores them."""
    sea = cfg.seanet()
    ns = cfg.num_semantic_quantizers
    out = {}
    _put_seanet(out, sd, seanet_encoder_plan(sea), "encoder", cfg)
    _put_seanet(out, sd, seanet_decoder_plan(sea), "decoder", cfg)
    _put_transformer(out, sd, "encoder_transformer", cfg)
    _put_transformer(out, sd, "decoder_transformer", cfg)
    put_conv(out, "downsample", sd, "downsample.conv", bias=False)
    out["upsample.w"] = to_np(sd["upsample.conv.weight"]).astype(np.float32)
    q = "quantizer"
    _put_rvq(out, sd, f"{q}.semantic_residual_vector_quantizer",
             f"{q}.semantic", ns)
    _put_rvq(out, sd, f"{q}.acoustic_residual_vector_quantizer",
             f"{q}.acoustic", cfg.num_quantizers - ns)
    return as_state_dict(out)
