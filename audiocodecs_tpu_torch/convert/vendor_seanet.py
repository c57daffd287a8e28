"""Vendor-naming SEANet checkpoint walker (the EnCodec lineage).

Counterpart of ``audiocodecs_tpu/convert/vendor_seanet.py``. The non-HF
EnCodec lineage (facebook/encodec and its forks: SpeechTokenizer,
audiocraft/PAST, WavTokenizer's feature extractor) names its SEANet stacks
alike, under a root prefix:

  {root}.model.<i>.conv.conv.{weight_g, weight_v, bias}        SConv1d
  {root}.model.<i>.convtr.convtr.{weight_g, weight_v, bias}    SConvTranspose1d
  {root}.model.<i>.block.{1,3}.conv.conv.*                     resnet convs
  {root}.model.<i>.shortcut.conv.conv.*                        resnet shortcut
  {root}.model.<i>.lstm.{weight_ih_l<n>, weight_hh_l<n>, bias_*}
      (and ``..._reverse`` where the LSTM is bidirectional)

The layer numbering equals the plan's indices (:func:`..nn.seanet.
seanet_encoder_plan`), which are the port's module names too. The schema
functions give the expected key → shape map for a config.
"""

from __future__ import annotations

import numpy as np

from audiocodecs_tpu_torch.convert.torch_utils import (
    lstm_schema,
    put_conv,
    put_lstm,
    to_np,
    wn_conv_schema,
)
from audiocodecs_tpu_torch.nn.seanet import (
    SEANetConfig,
    seanet_decoder_plan,
    seanet_encoder_plan,
)

__all__ = [
    "convert_vendor_seanet",
    "vendor_seanet_schema",
    "vendor_rvq_codebooks",
    "rvq_schema",
]

_BIDIRECTIONAL = (("fwd", ""), ("bwd", "_reverse"))


def convert_vendor_seanet(out: dict, sd, cfg: SEANetConfig, root: str,
                          decoder: bool = False, dst: str | None = None
                          ) -> None:
    """Walk one vendor SEANet stack at ``root`` into ``out`` under ``dst``
    (default: ``"decoder"`` or ``"encoder"``): the port's
    ``<dst>.<i>.w`` … keys, weights in their stored layouts."""
    plan = seanet_decoder_plan(cfg) if decoder else seanet_encoder_plan(cfg)
    dst = dst or ("decoder" if decoder else "encoder")
    for spec in plan:
        kind, idx = spec[0], spec[1]
        src, d = f"{root}.model.{idx}", f"{dst}.{idx}"
        if kind in ("conv", "convtr"):
            put_conv(out, d, sd, f"{src}.{kind}.{kind}")
        elif kind == "resnet":
            put_conv(out, f"{d}.block.0", sd, f"{src}.block.1.conv.conv")
            put_conv(out, f"{d}.block.1", sd, f"{src}.block.3.conv.conv")
            if any(k.startswith(f"{src}.shortcut.") for k in sd):
                put_conv(out, f"{d}.shortcut", sd,
                         f"{src}.shortcut.conv.conv")
        elif kind == "lstm":
            put_lstm(out, d, sd, f"{src}.lstm", cfg.num_lstm_layers)
        elif kind == "bilstm":
            put_lstm(out, d, sd, f"{src}.lstm", cfg.num_lstm_layers,
                     _BIDIRECTIONAL)
        elif kind != "elu":  # activations carry no weights
            raise ValueError(kind)


def vendor_seanet_schema(cfg: SEANetConfig, root: str,
                         decoder: bool = False) -> dict:
    """The vendor state dict's key → shape map for one SEANet stack."""
    plan = seanet_decoder_plan(cfg) if decoder else seanet_encoder_plan(cfg)
    schema: dict = {}
    for spec in plan:
        kind, idx = spec[0], spec[1]
        prefix = f"{root}.model.{idx}"
        if kind in ("conv", "convtr"):
            cin, cout, k = spec[2], spec[3], spec[4]
            name = "conv.conv" if kind == "conv" else "convtr.convtr"
            schema.update(wn_conv_schema(f"{prefix}.{name}", cout, cin, k,
                                         transpose=kind == "convtr"))
        elif kind == "resnet":
            ch = spec[2]
            hid = ch // cfg.compress
            schema.update(wn_conv_schema(f"{prefix}.block.1.conv.conv", hid,
                                         ch, cfg.residual_kernel_size))
            schema.update(wn_conv_schema(f"{prefix}.block.3.conv.conv", ch,
                                         hid, 1))
            if cfg.use_conv_shortcut:
                schema.update(wn_conv_schema(f"{prefix}.shortcut.conv.conv",
                                             ch, ch, 1))
        elif kind in ("lstm", "bilstm"):
            schema.update(lstm_schema(f"{prefix}.lstm", cfg.num_lstm_layers,
                                      spec[2], kind == "bilstm"))
    return schema


def vendor_rvq_codebooks(sd, num_quantizers: int,
                         root: str = "quantizer.vq.layers") -> np.ndarray:
    """``{root}.<k>._codebook.embed [C, H]`` → stacked ``[K, C, H]``."""
    return np.stack([
        to_np(sd[f"{root}.{k}._codebook.embed"]).astype(np.float32)
        for k in range(num_quantizers)])


def rvq_schema(num_quantizers: int, codebook_size: int, dim: int,
               root: str = "quantizer.vq.layers",
               buffers: bool = True) -> dict:
    """The vendor RVQ's keys: each stage's ``embed``, and with ``buffers``
    the EMA training buffers that vendor checkpoints carry."""
    schema = {}
    for k in range(num_quantizers):
        p = f"{root}.{k}._codebook"
        schema[f"{p}.embed"] = (codebook_size, dim)
        if buffers:
            schema[f"{p}.embed_avg"] = (codebook_size, dim)
            schema[f"{p}.cluster_size"] = (codebook_size,)
            schema[f"{p}.inited"] = (1,)
    return schema
