"""Per-family serving presets: the decoder's form for each serving tier.

Counterpart of ``audiocodecs_tpu/serving.py``, decision by decision. The
reference sets environment switches before its first trace; the port has
none, so a preset is the keyword arguments of the codec's constructor
(``decode_dtype``, ``decode_precision``, ``snake_poly``: the decoder's
:class:`audiocodecs_tpu_torch.models.dac.DecodeForm`). Tokens are the same
in every tier: the encoder and the quantizer run exact fp32 whatever the
decoder does.

Two of the reference's settings have no counterpart on the card:

* its ``"high"`` decoder precision (three bf16 passes) maps to ``"exact"``:
  cuDNN has no three-pass bf16 conv, and TF32 cannot be scoped to the
  decoder, because :func:`audiocodecs_tpu_torch.nn.layers.exact_fp32` owns
  the process-wide switch while a codec runs;
* its gate of the fused unit by batch (``ACX_PALLAS_DAC_RESUNIT`` for
  4 ≤ batch < 8 only) selects nothing: the port's kernel gate is fixed when
  a unit is built, so the fused unit runs at every batch.

Only DAC and BigCodec are listed so far; any other family gets ``{}``, its
constructor's exact default, the reference's rule for a family it does not
list.
"""

from __future__ import annotations

import torch

__all__ = ["SERVING_PRESETS", "apply_serving_preset"]

_EXACT = {"decode_dtype": torch.float32, "decode_precision": "exact",
          "snake_poly": False}
# DAC's latency tier: fp32 activations, the reference's "high" decoder
# convs, which are exact here
_DAC_STYLE = dict(_EXACT)
# bf16 decoder activations (one bf16 pass) and the polynomial snake: DAC's
# throughput tier and BigCodec's preset
_BF16_POLY = {"decode_dtype": torch.bfloat16, "decode_precision": "default",
              "snake_poly": True}

# family → the decoder's form under quality "balanced"
SERVING_PRESETS: dict[str, dict] = {
    "dac": _DAC_STYLE,
    "bigcodec": _BF16_POLY,
}


def apply_serving_preset(family: str, quality: str = "balanced",
                         batch: int | None = None) -> dict:
    """The constructor's keyword arguments for ``family``'s tier.

    ``quality``: ``"exact"`` (fp32 everywhere), ``"balanced"`` (the
    family's preset) or ``"fast"`` (one bf16 pass where the preset sets a
    decoder precision of its own: DAC's latency tier). ``batch``: the
    expected serving batch; DAC takes its throughput tier (bf16 activations
    and the polynomial snake) at ``batch >= 4``, its latency tier below or
    at ``None``. A family not listed gets ``{}`` in every quality."""
    if quality not in ("exact", "balanced", "fast"):
        raise ValueError(
            f"quality must be exact|balanced|fast, got {quality!r}")
    preset = SERVING_PRESETS.get(family)
    if preset is None:
        return {}
    if quality == "exact":
        return dict(_EXACT)
    kwargs = dict(preset)
    if batch is not None and batch >= 4 and preset is _DAC_STYLE:
        kwargs = dict(_BF16_POLY)
    elif quality == "fast" and preset is _DAC_STYLE:
        kwargs["decode_precision"] = "default"
    return kwargs
