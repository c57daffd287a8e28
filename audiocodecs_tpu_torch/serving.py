"""Per-family serving presets: the decoder's form for each serving tier.

Counterpart of ``audiocodecs_tpu/serving.py``, decision by decision. The
reference sets environment switches before its first trace; the port has
none, so a preset is the keyword arguments of the codec's constructor
(``decode_dtype``, ``decode_precision`` and, for DAC and BigCodec,
``snake_poly``: the decoder's :class:`audiocodecs_tpu_torch.nn.layers.
DecodeForm`). Tokens are the same in every tier: the encoder and the
quantizer run exact fp32 whatever the decoder does.

The EnCodec-style tier (``encodec``, ``mimi``, ``past``,
``speechtokenizer``, ``wavtokenizer``) is bf16 decoder activations
(``ACX_ACT_DTYPE=decoder-bfloat16``): every decoder conv one bf16 pass, the
fused SEANet blocks in their one-pass form on bf16 operands, the LSTMs fp32
islands. WavLM + K-means' and DyCAST's SEANet vocoders (``wavlm_kmeans``,
``dycast``) read the activation dtype too, and decode in bf16 (WavLM +
K-means' HiFi-GAN vocoder, ``vocoder_variant="hifigan"``, reads none and
decodes in exact fp32 in every tier). So does SemantiCodec's LDM decoder
(``semanticodec``): its bf16 tier casts the UNet's, the VAE's and the
vocoder's weights and the context to bf16, while the norms' statistics,
the softmax and the DDIM update stay fp32; ``decode_precision="default"``
with fp32 activations decodes it exactly, because the reference opens no
``conv_role("decoder")`` for SemantiCodec (its HiFi-GAN convs read only the
encoder's ``ACX_CONV_PRECISION``, its 2-D convs and products take XLA's
default precision, exact on the CPU). Its
``"fast"`` quality is its ``"balanced"`` one (the reference sets no decoder
precision of its own there), ``batch`` selects nothing for it, and
``"exact"`` is fp32. WavTokenizer's decoder, a Vocos head, reads no
activation dtype, so its tier decodes as its exact one. So do the zoo's
families that the reference lists under the same tier (``audiodec``,
``hilcodec``, ``nanocodec``, ``xcodec2``, ``stablecodec``, ``magicodec``,
``focalcodec``, ``bicodec``): none of their decoders reads the activation
dtype, and the tier sets no decoder precision, so the reference decodes
them in exact fp32. Their constructors take the tier's arguments, check
them, and decode exactly.

Three of the reference's settings have no counterpart on the card:

* its ``"high"`` decoder precision (three bf16 passes) maps to ``"exact"``:
  cuDNN has no three-pass bf16 conv, and TF32 cannot be scoped to the
  decoder, because :func:`audiocodecs_tpu_torch.nn.layers.exact_fp32` owns
  the process-wide switch while a codec runs;
* its gate of the fused unit by batch (``ACX_PALLAS_DAC_RESUNIT`` for
  4 ≤ batch < 8 only) selects nothing: the port's kernel gate is fixed when
  a unit is built, so the fused unit runs at every batch;
* SpeechTokenizer's ``ACX_PALLAS_LSTM_WIDE=decoder`` selects nothing: the
  port's recurrence kernel takes its H = 1024 LSTMs in every tier.

A family not listed gets ``{}``, its constructor's exact default, the
reference's rule for a family it does not list.
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
# the SEANet families: bf16 decoder activations, one bf16 pass
_ENCODEC_STYLE = {"decode_dtype": torch.bfloat16,
                  "decode_precision": "default"}
_SEANET_EXACT = {"decode_dtype": torch.float32, "decode_precision": "exact"}

# family → the decoder's form under quality "balanced"
SERVING_PRESETS: dict[str, dict] = {
    "encodec": _ENCODEC_STYLE,
    "mimi": _ENCODEC_STYLE,
    "past": _ENCODEC_STYLE,
    "speechtokenizer": _ENCODEC_STYLE,
    "wavtokenizer": _ENCODEC_STYLE,
    # the zoo's families under the same tier, which none of their decoders
    # reads: each decodes as its exact tier
    "audiodec": _ENCODEC_STYLE,
    "hilcodec": _ENCODEC_STYLE,
    "nanocodec": _ENCODEC_STYLE,
    "xcodec2": _ENCODEC_STYLE,
    "stablecodec": _ENCODEC_STYLE,
    "magicodec": _ENCODEC_STYLE,
    "focalcodec": _ENCODEC_STYLE,
    "bicodec": _ENCODEC_STYLE,
    # the WavLM families' SEANet vocoders read the activation dtype
    "wavlm_kmeans": _ENCODEC_STYLE,
    "dycast": _ENCODEC_STYLE,
    # the LDM decoder (UNet, VAE, HiFi-GAN) reads the activation dtype
    "semanticodec": _ENCODEC_STYLE,
    "dac": _DAC_STYLE,
    "bigcodec": _BF16_POLY,
}


def apply_serving_preset(family: str, quality: str = "balanced",
                         batch: int | None = None) -> dict:
    """The constructor's keyword arguments for ``family``'s tier.

    ``quality``: ``"exact"`` (fp32 everywhere), ``"balanced"`` (the
    family's preset) or ``"fast"`` (one bf16 pass where the preset sets a
    decoder precision of its own: DAC's latency tier; the preset itself
    elsewhere). ``batch``: the expected serving batch; DAC takes its
    throughput tier (bf16 activations and the polynomial snake) at
    ``batch >= 4``, its latency tier below or at ``None``; other families
    ignore it. A family not listed gets ``{}`` in every quality."""
    if quality not in ("exact", "balanced", "fast"):
        raise ValueError(
            f"quality must be exact|balanced|fast, got {quality!r}")
    preset = SERVING_PRESETS.get(family)
    if preset is None:
        return {}
    if quality == "exact":
        return dict(_SEANET_EXACT if preset is _ENCODEC_STYLE else _EXACT)
    kwargs = dict(preset)
    if batch is not None and batch >= 4 and preset is _DAC_STYLE:
        kwargs = dict(_BF16_POLY)
    elif quality == "fast" and preset is _DAC_STYLE:
        kwargs["decode_precision"] = "default"
    return kwargs
