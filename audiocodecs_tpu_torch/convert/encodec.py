"""HF EnCodec checkpoint → the port's :class:`..models.encodec.Encodec`.

Counterpart of ``audiocodecs_tpu/convert/encodec.py``. The
``facebook/encodec_*`` state dict names its SEANet stacks
``{encoder,decoder}.layers.<i>`` with the plan's layer indices
(:func:`..nn.seanet.seanet_encoder_plan`), so the walk is mechanical:

  {root}.layers.<i>.conv.{bias, parametrizations.weight.original0/1}
  {root}.layers.<i>.block.{1,3}.conv.*      a residual block's two convs
  {root}.layers.<i>.shortcut.conv.*         its 1×1 shortcut, where present
  {root}.layers.<i>.lstm.{weight_ih_l<n>, weight_hh_l<n>, bias_*}
  quantizer.layers.<k>.codebook.{embed, embed_avg, cluster_size, inited}

:func:`encodec_schema` is that surface (key → shape) for a config, the
weight-norm form ``transformers``' ``EncodecModel`` builds.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    as_state_dict,
    lstm_schema,
    put_conv,
    put_lstm,
    to_np,
    wn_conv_schema,
)
from audiocodecs_tpu_torch.models.encodec import EncodecModelConfig
from audiocodecs_tpu_torch.nn.seanet import (
    seanet_decoder_plan,
    seanet_encoder_plan,
)

__all__ = ["convert_encodec_state_dict", "encodec_config_from_hf",
           "encodec_schema"]

_FIELDS = ("sampling_rate", "audio_channels", "num_filters", "hidden_size",
           "kernel_size", "last_kernel_size", "residual_kernel_size",
           "dilation_growth_rate", "num_residual_layers", "compress",
           "num_lstm_layers", "use_causal_conv", "pad_mode",
           "use_conv_shortcut", "trim_right_ratio", "normalize",
           "chunk_length_s", "overlap", "codebook_size", "codebook_dim",
           "num_quantizers")


def encodec_config_from_hf(hf_config) -> EncodecModelConfig:
    """The architecture of any object with the attribute names of HF's
    ``EncodecConfig``."""
    return EncodecModelConfig(
        upsampling_ratios=tuple(hf_config.upsampling_ratios),
        **{f: getattr(hf_config, f) for f in _FIELDS})


def _put_plan(out, sd, plan, root: str, cfg: EncodecModelConfig) -> None:
    for spec in plan:
        kind, idx = spec[0], spec[1]
        src, dst = f"{root}.layers.{idx}", f"{root}.{idx}"
        if kind in ("conv", "convtr"):
            put_conv(out, dst, sd, f"{src}.conv")
        elif kind == "resnet":
            put_conv(out, f"{dst}.block.0", sd, f"{src}.block.1.conv")
            put_conv(out, f"{dst}.block.1", sd, f"{src}.block.3.conv")
            if any(k.startswith(f"{src}.shortcut.conv.") for k in sd):
                put_conv(out, f"{dst}.shortcut", sd, f"{src}.shortcut.conv")
        elif kind == "lstm":
            put_lstm(out, dst, sd, f"{src}.lstm", cfg.num_lstm_layers)


def convert_encodec_state_dict(sd, cfg: EncodecModelConfig) -> dict:
    """An HF EnCodec state dict → :class:`Encodec`'s (``encoder.*``,
    ``decoder.*``, ``codebooks [K, C, H]``). Keys it does not read are
    ignored, as the reference ignores them."""
    sea = cfg.seanet()
    out = {}
    _put_plan(out, sd, seanet_encoder_plan(sea), "encoder", cfg)
    _put_plan(out, sd, seanet_decoder_plan(sea), "decoder", cfg)
    out["codebooks"] = np.stack([
        to_np(sd[f"quantizer.layers.{k}.codebook.embed"]).astype(np.float32)
        for k in range(cfg.num_quantizers)])
    return as_state_dict(out)


def encodec_schema(cfg: EncodecModelConfig) -> dict:
    """The HF ``EncodecModel`` state dict's keys and shapes for ``cfg``."""
    sea = cfg.seanet()
    schema = {}
    for root, plan in (("encoder", seanet_encoder_plan(sea)),
                       ("decoder", seanet_decoder_plan(sea))):
        for spec in plan:
            kind, idx = spec[0], spec[1]
            p = f"{root}.layers.{idx}"
            if kind in ("conv", "convtr"):
                cin, cout, k = spec[2], spec[3], spec[4]
                schema.update(wn_conv_schema(f"{p}.conv", cout, cin, k,
                                             kind == "convtr", True))
            elif kind == "resnet":
                ch = spec[2]
                hid = ch // cfg.compress
                schema.update(wn_conv_schema(f"{p}.block.1.conv", hid, ch,
                                             cfg.residual_kernel_size,
                                             parametrized=True))
                schema.update(wn_conv_schema(f"{p}.block.3.conv", ch, hid, 1,
                                             parametrized=True))
                if cfg.use_conv_shortcut:
                    schema.update(wn_conv_schema(f"{p}.shortcut.conv", ch,
                                                 ch, 1, parametrized=True))
            elif kind == "lstm":
                schema.update(lstm_schema(f"{p}.lstm", cfg.num_lstm_layers,
                                          spec[2]))
    C, H = cfg.codebook_size, cfg.codebook_dim
    for k in range(cfg.num_quantizers):
        p = f"quantizer.layers.{k}.codebook"
        schema.update({f"{p}.inited": (1,), f"{p}.cluster_size": (C,),
                       f"{p}.embed": (C, H), f"{p}.embed_avg": (C, H)})
    return schema
