"""The port's serving presets (``audiocodecs_tpu_torch.serving``) against the
JAX package's ``audiocodecs_tpu/serving.py``, decision for decision.

The reference returns environment switches; the port returns the codec's
constructor arguments. The map between them: bf16 decoder activations
(``ACX_ACT_DTYPE=decoder-bfloat16``) are ``decode_dtype=bfloat16`` and one
bf16 pass; ``ACX_DEC_CONV_PRECISION=default`` is ``decode_precision=
"default"``, its "high" (and unset) ``"exact"``; ``ACX_SNAKE_APPROX=1`` is
``snake_poly`` (DAC and BigCodec only: the SEANet families take no
snake). The reference's fused-unit switch and its wide-LSTM switch have no
counterpart (the port's gates are fixed at build time). Families the port
does not list get ``{}`` in every quality.
"""

import os

import pytest
import torch

from audiocodecs_tpu.serving import SERVING_PRESETS as J_PRESETS
from audiocodecs_tpu.serving import apply_serving_preset as j_apply
from audiocodecs_tpu_torch.models.bigcodec import BigCodec, BigCodecModelConfig
from audiocodecs_tpu_torch.models.dac import DAC, DACModelConfig, DecodeForm
from audiocodecs_tpu_torch.serving import (
    SERVING_PRESETS,
    apply_serving_preset,
)

_KNOBS = ("ACX_ACT_DTYPE", "ACX_CONV_PRECISION", "ACX_DEC_CONV_PRECISION",
          "ACX_SNAKE_APPROX", "ACX_PALLAS_DAC_RESUNIT",
          "ACX_PALLAS_LSTM_WIDE")
_BATCHES = (None, 1, 2, 3, 4, 5, 7, 8, 16)


@pytest.fixture(autouse=True)
def clean_env():
    """The reference writes ``os.environ``: snapshot the switches and put
    them back, so that no later test sees them."""
    saved = {k: os.environ.pop(k, None) for k in _KNOBS}
    yield
    for k in _KNOBS:
        os.environ.pop(k, None)
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v


SEANET_FAMILIES = ("encodec", "mimi", "past", "speechtokenizer",
                   "wavtokenizer")
# the zoo's families under the EnCodec-style tier: whether the decoder
# reads the activation dtype (WavLM + K-means' and DyCAST's SEANet vocoders
# and SemantiCodec's LDM decoder do, and decode in bf16; the others do not,
# so the tier decodes exactly:
# the tier tests of tests/test_torch_zoo_*.py and test_torch_xcodec2.py
# hold each such decode bit for bit to its exact tier's, as the
# reference's)
ZOO_READS_ACT_DTYPE = {"audiodec": False, "hilcodec": False,
                       "nanocodec": False, "xcodec2": False,
                       "stablecodec": False, "magicodec": False,
                       "wavlm_kmeans": True, "dycast": True,
                       "focalcodec": False, "bicodec": False,
                       "semanticodec": True}
ENCODEC_STYLE = (*SEANET_FAMILIES, *ZOO_READS_ACT_DTYPE)


def _port_form(env: dict, family: str) -> dict:
    bf16 = env.get("ACX_ACT_DTYPE", "float32") in ("bfloat16",
                                                   "decoder-bfloat16")
    one_pass = bf16 or env.get("ACX_DEC_CONV_PRECISION") == "default"
    form = {"decode_dtype": torch.bfloat16 if bf16 else torch.float32,
            "decode_precision": "default" if one_pass else "exact"}
    if family not in ENCODEC_STYLE:
        form["snake_poly"] = env.get("ACX_SNAKE_APPROX") == "1"
    else:  # the EnCodec-style env sets no snake and no encoder precision
        assert env.get("ACX_SNAKE_APPROX", "") == ""
        assert env.get("ACX_CONV_PRECISION", "highest") == "highest"
    if not ZOO_READS_ACT_DTYPE.get(family, True):
        # nor a decoder precision: a decoder that reads no activation
        # dtype runs at "highest", the exact form the port decodes in
        assert env.get("ACX_DEC_CONV_PRECISION", "") == ""
    return form


@pytest.mark.parametrize("quality", ["exact", "balanced", "fast"])
@pytest.mark.parametrize("family", ["dac", "bigcodec", *ENCODEC_STYLE,
                                    "nosuchfamily"])
def test_presets_agree_with_the_reference(family, quality):
    """Every batch, the DAC crossover at 4 included: the port's arguments
    are the reference's switches through the map above."""
    for batch in _BATCHES:
        env = j_apply(family, quality, batch)
        got = apply_serving_preset(family, quality, batch)
        if family in SERVING_PRESETS:
            assert got == _port_form(env, family), (family, quality, batch)
        else:
            assert got == {}
            if family not in J_PRESETS and quality != "exact":
                assert env == {}  # the reference's rule for it too


def test_listed_families_and_their_tiers():
    assert sorted(SERVING_PRESETS) == sorted(["bigcodec", "dac",
                                              *ENCODEC_STYLE])
    bf16_poly = {"decode_dtype": torch.bfloat16,
                 "decode_precision": "default", "snake_poly": True}
    exact = {"decode_dtype": torch.float32, "decode_precision": "exact",
             "snake_poly": False}
    assert apply_serving_preset("dac") == exact  # latency: "high" ↦ exact
    assert apply_serving_preset("dac", "fast") == {
        **exact, "decode_precision": "default"}
    for batch in (4, 7, 8, 64):  # throughput, with the fused unit at all
        assert apply_serving_preset("dac", batch=batch) == bf16_poly
        assert apply_serving_preset("dac", "fast", batch) == bf16_poly
    assert apply_serving_preset("bigcodec") == bf16_poly
    assert apply_serving_preset("bigcodec", "fast") == bf16_poly
    for family in ("dac", "bigcodec"):
        assert apply_serving_preset(family, "exact") == exact
    bf16 = {"decode_dtype": torch.bfloat16, "decode_precision": "default"}
    for family in ENCODEC_STYLE:  # fast is balanced; batch selects nothing
        for quality in ("balanced", "fast"):
            for batch in _BATCHES:
                assert apply_serving_preset(family, quality, batch) == bf16
        assert apply_serving_preset(family, "exact") == {
            "decode_dtype": torch.float32, "decode_precision": "exact"}
    with pytest.raises(ValueError, match="quality"):
        apply_serving_preset("dac", "turbo")
    with pytest.raises(ValueError, match="quality"):
        j_apply("dac", "turbo")


@pytest.mark.parametrize("quality,batch", [("exact", None),
                                           ("balanced", None),
                                           ("fast", None),
                                           ("balanced", 8)])
def test_every_preset_builds_its_codec(quality, batch):
    """The arguments build DAC and BigCodec, whose decoders take the form;
    a bf16 form without one bf16 pass is refused."""
    dac = DAC(16000, num_codebooks=2, device="cpu",
              model_config=DACModelConfig(
                  encoder_hidden_size=4, downsampling_ratios=(2,),
                  decoder_hidden_size=8, upsampling_ratios=(2,),
                  hidden_size=8, n_codebooks=2, codebook_size=16,
                  codebook_dim=4),
              **apply_serving_preset("dac", quality, batch))
    kw = apply_serving_preset("dac", quality, batch)
    assert dac.decode_form == DecodeForm(*kw.values())
    assert all(u.form == dac.decode_form
               for u in dac.decoder.modules() if hasattr(u, "dilation"))
    big = BigCodec(16000, device="cpu",
                   model_config=BigCodecModelConfig(
                       ngf=2, up_ratios=(2,), dilations=(1,), hidden_size=8,
                       codebook_size=16, codebook_dim=4, rnn_layers=1),
                   **apply_serving_preset("bigcodec", quality, batch))
    assert big.decoder.form == big.decode_form
    assert all(u.form == DecodeForm()
               for u in big.encoder.modules() if hasattr(u, "dilation"))
    with pytest.raises(ValueError, match="one bf16 pass"):
        DecodeForm(torch.bfloat16, "exact")


def _small_codec(family, **kw):
    """``family`` at a small config on the CPU, built with ``kw``."""
    from audiocodecs_tpu_torch.models import get_codec_class

    cls = get_codec_class(family)
    small = dict(num_filters=4, upsampling_ratios=(2, 2), hidden_size=8,
                 num_lstm_layers=1)
    if family == "encodec":
        from audiocodecs_tpu_torch.models.encodec import EncodecModelConfig

        mc = EncodecModelConfig(codebook_size=16, codebook_dim=8,
                                num_quantizers=2, **small)
        return cls(24000, 24000, num_codebooks=2, model_config=mc,
                   device="cpu", **kw)
    if family == "past":
        from audiocodecs_tpu_torch.models.seanet_rvq import SEANetRVQConfig

        mc = SEANetRVQConfig(codebook_size=16, codebook_dim=8,
                             num_quantizers=2, **small)
        return cls(16000, 16000, num_codebooks=2, model_config=mc,
                   device="cpu", **kw)
    if family == "speechtokenizer":
        from audiocodecs_tpu_torch.models.speechtokenizer import (
            SpeechTokenizerModelConfig)

        mc = SpeechTokenizerModelConfig(codebook_size=16, codebook_dim=8,
                                        num_quantizers=2, **small)
        return cls(16000, 16000, num_codebooks=2, model_config=mc,
                   device="cpu", **kw)
    return cls(cls.default_model_config().sampling_rate, device="cpu", **kw)


@pytest.mark.parametrize("quality", ["exact", "balanced"])
@pytest.mark.parametrize("family", ["encodec", "past", "speechtokenizer"])
def test_every_seanet_preset_builds_its_codec(family, quality):
    """The arguments build the SEANet families: the decoder stack takes the
    tier's form, the encoder stack stays exact fp32; an unknown encoder
    precision is refused."""
    kw = apply_serving_preset(family, quality)
    codec = _small_codec(family, **kw)
    assert codec.decode_form == DecodeForm(*kw.values())
    assert codec.decoder.form == codec.decode_form
    assert codec.encoder.form == DecodeForm() == codec.encode_form
    with pytest.raises(ValueError, match="encode_precision"):
        _small_codec(family, encode_precision="high")
