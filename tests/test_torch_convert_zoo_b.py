"""The port's converters for the rest of the zoo (X-Codec 2.0, BiCodec,
StableCodec, NanoCodec, AudioDec, MagiCodec, FocalCodec, HILCodec, DyCAST)
against the JAX package's, on the JAX package's documented vendor schemas.

No vendor checkpoint is installed, so each case fills the JAX schema with
seeded values (``tests/test_zoo_converters.py``'s ``synth_state_dict``)
and requires the port's converter to give ``from_jax_params(<the JAX
converter>(sd), port_model)``: the same keys, every tensor equal bit for
bit, weight-norm folds within 2 float32 ulp. The port model there is built
on the meta device (``meta_codec``): ``from_jax_params`` reads only its
names, types and shapes. The port's schemas equal the JAX package's at the
small and the published configs; the converters refuse a key they do not
read where the JAX package's refuse it, raise on a missing key, take a
``key_map`` overlay where the family does, and a converted codec loads and
runs. ``synth_state_dict`` draws batch-norm variances positive.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from audiocodecs_tpu.convert import zoo as jax_zoo  # noqa: E402
from audiocodecs_tpu.models import audiodec as j_audiodec  # noqa: E402
from audiocodecs_tpu.models import bicodec as j_bicodec  # noqa: E402
from audiocodecs_tpu.models import dycast as j_dycast  # noqa: E402
from audiocodecs_tpu.models import focalcodec as j_focal  # noqa: E402
from audiocodecs_tpu.models import hilcodec as j_hil  # noqa: E402
from audiocodecs_tpu.models import magicodec as j_magi  # noqa: E402
from audiocodecs_tpu.models import nanocodec as j_nano  # noqa: E402
from audiocodecs_tpu.models import stablecodec as j_stable  # noqa: E402
from audiocodecs_tpu.models import xcodec2 as j_xcodec2  # noqa: E402
from audiocodecs_tpu.nn.w2vbert import W2VBertConfig as JW2VConfig  # noqa
from audiocodecs_tpu.nn.wavlm import WavLMConfig as JWavLMConfig  # noqa
from audiocodecs_tpu_torch.convert import torch_utils, zoo  # noqa: E402
from audiocodecs_tpu_torch.models import audiodec, bicodec, dycast  # noqa
from audiocodecs_tpu_torch.models import focalcodec, hilcodec  # noqa: E402
from audiocodecs_tpu_torch.models import magicodec, nanocodec  # noqa: E402
from audiocodecs_tpu_torch.models import stablecodec, xcodec2  # noqa: E402
from audiocodecs_tpu_torch.params import from_jax_params  # noqa: E402
from test_zoo_converters import synth_state_dict  # noqa: E402
from zoo_pairs import (  # noqa: E402,F401
    assert_same_state,
    meta_codec,
    one_thread,
    port_config,
)

_TINY_WAVLM = JWavLMConfig(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_distance=50)
_TINY_LARGE = dataclasses.replace(_TINY_WAVLM, do_stable_layer_norm=True,
                                  feat_extract_norm="layer", conv_bias=True)

# the small configs of tests/test_zoo_converters.py (BiCodec's and
# DyCAST's of tests/test_torch_zoo_wavlm.py): JAX config, port codec and
# config classes, the JAX class for the published config, the codec's
# keywords
_SMALL = {
    "xcodec2": j_xcodec2.XCodec2ModelConfig(
        ngf=4, acoustic_dim=16, semantic_dim=16, fused_dim=32,
        w2vbert=JW2VConfig(hidden_size=16, num_layers=2, num_heads=2,
                           intermediate_size=32, input_dim=160,
                           conv_kernel=5),
        semantic_layer=2, backbone_depth=2, backbone_heads=2),
    "bicodec": j_bicodec.BiCodecModelConfig(
        w2v=dataclasses.replace(_TINY_LARGE, gated_rel_pos=False),
        feat_layers=(1, 2), encoder_dim=8, encoder_intermediate_dim=16,
        encoder_layers=2, latent_dim=16, codebook_size=64, codebook_dim=8,
        num_mels=20, n_fft=64, win_length=40, hop_length=20,
        speaker_channels=16, speaker_dim=16, perceiver_dim=8,
        perceiver_depth=1, fsq_levels=(4, 4, 4), prenet_dim=8,
        prenet_intermediate_dim=16, prenet_layers=2, decoder_channels=16,
        decoder_rates=(4, 5), decoder_kernels=(8, 10)),
    "stablecodec": dataclasses.replace(
        j_stable.StableCodec.default_model_config(bottleneck=(2, 15625)),
        patch=8, dim=16, depth_outer=2, depth_inner=1, num_heads=2),
    "nanocodec": j_nano.NanoCodecModelConfig(
        sampling_rate=800, base_channels=4, down_sample_rates=(4, 2),
        resblock_kernels=(3, 5), resblock_dilations=(1, 3),
        levels=(5, 5, 5), num_groups=4),
    "audiodec": j_audiodec.AudioDecModelConfig(
        sampling_rate=1200, encode_channels=4, channel_ratios=(2, 4),
        strides=(3, 4), code_dim=8, codebook_size=32, num_quantizers=4),
    "magicodec": j_magi.MagiCodecModelConfig(
        hop_length=8, dim=16, depth=2, num_heads=2, codebook_size=64,
        codebook_dim=8),
    "focalcodec": j_focal.FocalCodecModelConfig(
        codebook_bits=6, wavlm=_TINY_LARGE, wavlm_layer=2,
        compressor_blocks=2, vocos_dim=8, vocos_intermediate_dim=16,
        vocos_layers=2, n_fft=80, hop_length=20),
    "hilcodec": j_hil.HILCodecModelConfig(
        sampling_rate=800, channels=4, max_channels=16, strides=(4, 2),
        emb_dim=16, codebook_size=8, num_quantizers=2),
    "dycast": j_dycast.DyCASTModelConfig(
        num_channels=8, max_segments=8, max_duration=8, wavlm=_TINY_WAVLM,
        wavlm_layer=2, vocoder_filters=4, vocoder_ratios=(5, 2, 2),
        use_retriever=True, retriever_bank_size=8),
}
# the codec's keywords for a config (a codec keeps its first K codebooks)
_ALL_CODEBOOKS = "all codebooks"
_CLASSES = {
    "xcodec2": (xcodec2.XCodec2, xcodec2.XCodec2ModelConfig,
                j_xcodec2.XCodec2, {}),
    "bicodec": (bicodec.BiCodec, bicodec.BiCodecModelConfig,
                j_bicodec.BiCodec, {}),
    "stablecodec": (stablecodec.StableCodec,
                    stablecodec.StableCodecModelConfig,
                    j_stable.StableCodec, {}),
    "nanocodec": (nanocodec.NanoCodec, nanocodec.NanoCodecModelConfig,
                  j_nano.NanoCodec, {}),
    "audiodec": (audiodec.AudioDec, audiodec.AudioDecModelConfig,
                 j_audiodec.AudioDec, _ALL_CODEBOOKS),
    "magicodec": (magicodec.MagiCodec, magicodec.MagiCodecModelConfig,
                  j_magi.MagiCodec, {}),
    "focalcodec": (focalcodec.FocalCodec,
                   focalcodec.FocalCodecModelConfig, j_focal.FocalCodec,
                   {}),
    "hilcodec": (hilcodec.HILCodec, hilcodec.HILCodecModelConfig,
                 j_hil.HILCodec, _ALL_CODEBOOKS),
    "dycast": (dycast.DyCAST, dycast.DyCASTModelConfig, j_dycast.DyCAST,
               {}),
}
FAMILIES = list(_SMALL)
# the families whose converter takes ``key_map=``
KEY_MAPPED = ["stablecodec", "magicodec", "focalcodec", "hilcodec",
              "dycast"]


def _bicodec_parts(convert, schema, wavlm_schema):
    """BiCodec's two files (its own, the XLSR tower's) as one mapping of
    parts, as BigCodec's ``{"CodecEnc", "generator"}``."""
    return (lambda ck, cfg: convert(ck["bicodec"], cfg, w2v_sd=ck["w2v"]),
            lambda cfg: {"bicodec": schema(cfg),
                         "w2v": wavlm_schema(cfg.w2v)})


def _converters(name):
    """(port converter, JAX converter, port schema, JAX schema)."""
    if name == "bicodec":
        port, schema = _bicodec_parts(zoo.convert_bicodec_state_dict,
                                      zoo.bicodec_schema, zoo.wavlm_schema)
        ref, jax_schema = _bicodec_parts(jax_zoo.convert_bicodec_state_dict,
                                         jax_zoo.bicodec_schema,
                                         jax_zoo._wavlm_schema)
        return port, ref, schema, jax_schema
    if name == "hilcodec":  # the whole towers (the adapter: see below)
        return (zoo.convert_hilcodec_full_state_dict,
                jax_zoo.convert_hilcodec_full_state_dict,
                zoo.hilcodec_schema, jax_zoo.hilcodec_schema)
    return tuple(getattr(mod, f"{pre}{name}{post}")
                 for mod, pre, post in (
                     (zoo, "convert_", "_state_dict"),
                     (jax_zoo, "convert_", "_state_dict"),
                     (zoo, "", "_schema"), (jax_zoo, "", "_schema")))


def _family(name, published=False):
    """(JAX config, port config, port codec class, codec keywords)."""
    cls, cfg_cls, jcls, kw = _CLASSES[name]
    jcfg = jcls.default_model_config() if published else _SMALL[name]
    if kw == _ALL_CODEBOOKS:
        kw = {"num_codebooks": jcfg.num_quantizers}
    return jcfg, port_config(cfg_cls, jcfg), cls, kw


def _synth(schema, synth=synth_state_dict):
    if all(isinstance(v, dict) for v in schema.values()):
        return {part: synth(s, seed=i)
                for i, (part, s) in enumerate(schema.items())}
    return synth(schema)


def _codec(cls, cfg, sd, kw, build=None):
    sr = cfg.sampling_rate
    if build is not None:
        return build(cls, sr, sr, model_config=cfg, state_dict=sd, **kw)
    return cls(sr, sr, model_config=cfg, state_dict=sd, device="cpu", **kw)


def _folded(k: str) -> bool:
    """A weight-norm fold: the WN convs' weights, the quantizer's 1×1
    projections and the WavLM tower's positional conv."""
    return k.endswith(".w") or k.endswith("_proj.w")


def _flat(sd):
    """The part of a checkpoint that holds the family's own keys."""
    return sd["bicodec"] if "bicodec" in sd else sd


# ----------------------------------------------------------------------- #
# Against the JAX package's converters
# ----------------------------------------------------------------------- #

def _check_against_jax(name, published):
    jcfg, cfg, cls, kw = _family(name, published)
    port, ref, _, jax_schema = _converters(name)
    sd = _synth(jax_schema(jcfg), synth_state_dict if not published
                else torch_utils.synth_state_dict)
    got = port(sd, cfg)
    want = from_jax_params(ref(sd, jcfg), _codec(cls, cfg, got, kw,
                                                 meta_codec))
    assert_same_state(got, want, folded=_folded)


@pytest.mark.parametrize("name", FAMILIES)
def test_matches_the_jax_converter(name):
    _check_against_jax(name, published=False)


# the published configs with a layout the small ones lack: NanoCodec's
# half-snake at 48..1536 channels and its transposed convs at strides
# (7, 7, 6, 3, 2); AudioDec's at (8, 5, 4, 2); HILCodec's channel cap and
# 1-channel skip heads at strides (8, 5, 4, 2)
@pytest.mark.parametrize("name", ["nanocodec", "audiodec", "hilcodec"])
def test_matches_the_jax_converter_at_the_published_config(name):
    _check_against_jax(name, published=True)


@pytest.mark.parametrize("published", [False, True],
                         ids=["small", "published"])
@pytest.mark.parametrize("name", FAMILIES)
def test_schema_is_the_jax_packages(name, published):
    jcfg, cfg, *_ = _family(name, published)
    *_, schema, jax_schema = _converters(name)
    assert schema(cfg) == jax_schema(jcfg)


def test_tower_schemas_are_the_jax_packages():
    """The HF towers' schemas that X-Codec 2.0, FocalCodec, BiCodec and
    DyCAST nest, under a prefix, at the published widths."""
    x = _family("xcodec2", True)
    assert zoo.w2vbert_schema(x[1].w2vbert, "p.") == \
        jax_zoo._w2vbert_schema(x[0].w2vbert, "p.")
    for name, field in (("focalcodec", "wavlm"), ("bicodec", "w2v"),
                        ("dycast", "wavlm")):
        jcfg, cfg, *_ = _family(name, True)
        assert zoo.wavlm_schema(getattr(cfg, field), "e.") == \
            jax_zoo._wavlm_schema(getattr(jcfg, field), "e.")


# the buffers a family's converter tolerates without a schema entry
_TOLERATED = {
    "xcodec2": "generator.quantizer.fsq.implicit_codebook",
    "bicodec": "speaker_encoder.speaker_encoder.bn.num_batches_tracked",
    "nanocodec": "vector_quantizer.fsqs.0.num_levels",
    "focalcodec": "quantizer.codebook",
    "dycast": "codebook",
    "audiodec": "quantizer.codebook.layers.0.embed_avg",
}


@pytest.mark.parametrize("name", FAMILIES)
def test_unmapped_key_raises_where_the_jax_converter_does(name):
    jcfg, cfg, *_ = _family(name)
    port, ref, schema, _ = _converters(name)
    sd = _synth(schema(cfg))
    if name in _TOLERATED:
        _flat(sd)[_TOLERATED[name]] = np.zeros((4,), np.float32)
        port(sd, cfg)
        ref(sd, jcfg)
    _flat(sd)["encoder.mystery.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="unmapped.*encoder.mystery"):
        port(sd, cfg)
    with pytest.raises(ValueError, match="unmapped"):
        ref(sd, jcfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_renamed_key_raises(name):
    """A key of the schema under another name: missing where it is read
    (``KeyError``), or refused as unmapped, as by the JAX converter."""
    jcfg, cfg, *_ = _family(name)
    port, ref, schema, _ = _converters(name)
    sd = _synth(schema(cfg))
    flat = _flat(sd)
    key = sorted(flat)[len(flat) // 2]
    flat[key.replace(".", "._", 1)] = flat.pop(key)
    with pytest.raises((KeyError, ValueError)) as got:
        port(sd, cfg)
    with pytest.raises(got.type):
        ref(sd, jcfg)


# a vendor prefix the schema does not use, and an overlay that undoes it
_RENAMED = {"stablecodec": ("encoder.", "model.enc."),
            "magicodec": ("encoder.transformers.", "encoder.blocks."),
            "focalcodec": ("compressor.", "down_path."),
            "hilcodec": ("encoder.blocks.", "encoder.units."),
            "dycast": ("encoder.", "ssl_model.")}


@pytest.mark.parametrize("name", KEY_MAPPED)
def test_key_map_repairs_a_renamed_prefix(name, tmp_path):
    jcfg, cfg, *_ = _family(name)
    port, ref, schema, _ = _converters(name)
    if name == "hilcodec":
        port = zoo.convert_hilcodec_state_dict
    sd = _synth(schema(cfg))
    src, dst = _RENAMED[name]
    vendor = {(dst + k[len(src):] if k.startswith(src) else k): v
              for k, v in sd.items()}
    vendor["optimizer.step"] = np.zeros((1,), np.float32)
    key_map = {"prefix": {dst: src}, "drop": ["optimizer.*"]}
    path = tmp_path / "key_map.json"
    path.write_text(json.dumps(key_map))
    want = port(sd, cfg)
    for km in (key_map, str(path)):
        assert_same_state(port(vendor, cfg, key_map=km), want)
    with pytest.raises((KeyError, ValueError)):
        port(vendor, cfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_converted_codec_runs(name):
    """A converted small codec loads strictly and roundtrips to a finite
    waveform."""
    _, cfg, cls, kw = _family(name)
    port, _, schema, _ = _converters(name)
    codec = _codec(cls, cfg, port(_synth(schema(cfg),
                                         torch_utils.synth_state_dict), cfg),
                   kw)
    sig = np.random.default_rng(0).standard_normal((2, 3200)).astype(
        np.float32) * np.float32(0.1)
    with torch.no_grad():
        y = codec.roundtrip(sig)
    assert y.shape[0] == 2 and bool(torch.isfinite(y).all())


# ----------------------------------------------------------------------- #
# Family details
# ----------------------------------------------------------------------- #

def test_bicodec_wants_its_xlsr_tower():
    """Without ``w2v_sd`` the converter raises, as the JAX package's does;
    ``allow_random_w2v`` draws the tower from the port's own init (seeded,
    another draw than the JAX package's) and converts the rest."""
    jcfg, cfg, cls, kw = _family("bicodec")
    sd = zoo.bicodec_schema(cfg)
    sd = synth_state_dict(sd)
    with pytest.raises(ValueError, match="w2v"):
        zoo.convert_bicodec_state_dict(sd, cfg)
    with pytest.raises(ValueError, match="w2v"):
        jax_zoo.convert_bicodec_state_dict(sd, jcfg)
    a = zoo.convert_bicodec_state_dict(sd, cfg, allow_random_w2v=True)
    b = zoo.convert_bicodec_state_dict(sd, cfg, allow_random_w2v=True)
    assert_same_state(a, b)
    meta_codec(cls, 16000, 16000, model_config=cfg, state_dict=a, **kw)


def test_stablecodec_swiglu_halves_are_value_then_gate():
    """``ff.0.proj [2F, C]``: rows :F the value (``w1``), F: the gate
    (``wg``), each transposed."""
    _, cfg, *_ = _family("stablecodec")
    sd = synth_state_dict(zoo.stablecodec_schema(cfg))
    got = zoo.convert_stablecodec_state_dict(sd, cfg)
    glu = sd["encoder.outer.layers.1.ff.ff.0.proj.weight"]
    F = glu.shape[0] // 2
    assert np.array_equal(got["enc_outer.blocks.1.ffn.w1"].numpy(),
                          glu[:F].T)
    assert np.array_equal(got["enc_outer.blocks.1.ffn.wg"].numpy(),
                          glu[F:].T)


def test_hilcodec_partial_conversion_is_opt_in():
    """Towers that do not convert: a ``ValueError`` naming the port's
    inspect tool, or with ``allow_partial`` a warning and the codebooks
    alone in the base (the port's seeded init)."""
    _, cfg, cls, kw = _family("hilcodec")
    sd = synth_state_dict(zoo.hilcodec_schema(cfg))
    quant = {k: v for k, v in sd.items() if k.startswith("quantizer.")}
    with pytest.raises(ValueError, match="inspect_checkpoint_torch"):
        zoo.convert_hilcodec_state_dict(quant, cfg)
    with pytest.warns(UserWarning, match="did not convert"):
        got = zoo.convert_hilcodec_state_dict(quant, cfg,
                                              allow_partial=True)
    base = zoo.convert_hilcodec_components(cfg)
    assert sorted(got) == sorted(base)
    for k in base:
        want = (np.stack([quant[f"quantizer.layers.{i}.embed"]
                          for i in range(cfg.num_quantizers)])
                if k == "codebooks" else base[k].numpy())
        assert np.array_equal(got[k].numpy(), want), k
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a whole checkpoint: no warning
        full = zoo.convert_hilcodec_state_dict(sd, cfg, allow_partial=True)
    assert_same_state(full, zoo.convert_hilcodec_full_state_dict(sd, cfg))
    with pytest.raises(ValueError, match="shape"):
        zoo.convert_hilcodec_components(cfg, quantizer_sd={
            f"quantizer.layers.{k}.embed": np.zeros((8, 4), np.float32)
            for k in range(2)})


def test_dycast_projection_shapes_are_checked():
    jcfg, cfg, *_ = _family("dycast")
    sd = synth_state_dict(zoo.dycast_schema(cfg))
    sd["compressor.proj.weight"] = sd["compressor.proj.weight"][:-1]
    with pytest.raises(ValueError, match="compressor.proj"):
        zoo.convert_dycast_state_dict(sd, cfg)
    with pytest.raises(ValueError, match="compressor.proj"):
        jax_zoo.convert_dycast_state_dict(sd, jcfg)


# ----------------------------------------------------------------------- #
# synth_state_dict's batch-norm statistics
# ----------------------------------------------------------------------- #

_GAINS_BEFORE = ("weight_g", "original0", "alpha", "cluster_size",
                 "cluster_usage")


def _synth_before(schema, seed=0):
    """``synth_state_dict`` as it drew before batch-norm variances were
    drawn as gains: every 1-D leaf not named ``weight`` (and not a gain)
    N(0, 0.1²)."""
    import math

    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in schema.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in _GAINS_BEFORE or (leaf == "weight" and len(shape) == 1):
            a = rng.random(shape, dtype=np.float32) + np.float32(0.5)
        elif leaf in ("inited", "initialized"):
            a = np.ones(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            if leaf in torch_utils._UNIT or "codebook" in key:
                pass
            elif len(shape) >= 2:
                a *= np.float32(1.0 / math.sqrt(math.prod(shape[1:])))
            else:
                a *= np.float32(0.1)
        sd[key] = a
    return sd


def test_synth_draws_batch_norm_variances_positive():
    """Every ``running_var`` of BiCodec's draw (ECAPA's batch norms) in
    [0.5, 1.5], so ECAPA's ``1/√var`` stays finite on the card."""
    _, cfg, *_ = _family("bicodec", published=True)
    sd = torch_utils.synth_state_dict(zoo.bicodec_schema(cfg))
    var = [a for k, a in sd.items() if k.endswith("running_var")]
    assert var
    assert all(a.min() >= 0.5 and a.max() <= 1.5 for a in var)


def test_synth_draws_of_the_loading_phase_are_unchanged():
    """The five schemas that the chip's loading phase (35) draws at their
    published widths hold no batch-norm statistic, so the positive
    variances leave those draws as they were (checked bit for bit at the
    small configs of ``tests/test_torch_convert_zoo.py``)."""
    from audiocodecs_tpu_torch.convert.dac import dac_schema
    from audiocodecs_tpu_torch.convert.encodec import encodec_schema
    from audiocodecs_tpu_torch.models.bigcodec import BigCodecModelConfig
    from audiocodecs_tpu_torch.models.dac import DAC
    from audiocodecs_tpu_torch.models.encodec import EncodecModelConfig
    from audiocodecs_tpu_torch.models.past import PAST
    from audiocodecs_tpu_torch.models.speechtokenizer import (
        SpeechTokenizerModelConfig)
    from test_torch_convert_zoo import _family as zoo_family

    published = [encodec_schema(EncodecModelConfig()),
                 dac_schema(DAC.default_model_config(44100)),
                 zoo.speechtokenizer_schema(SpeechTokenizerModelConfig()),
                 zoo.past_schema(PAST.default_model_config()),
                 *zoo.bigcodec_schema(BigCodecModelConfig()).values()]
    for schema in published:
        assert not [k for k in schema if "running_" in k]
    for name in ("speechtokenizer", "past", "bigcodec"):
        cfg, *_, schema, _ = zoo_family(name, False)
        parts = schema(cfg)
        for part in parts.values() if name == "bigcodec" else [parts]:
            new = torch_utils.synth_state_dict(part, 3)
            old = _synth_before(part, 3)
            assert sorted(new) == sorted(old)
            for k in new:
                assert new[k].tobytes() == old[k].tobytes(), k
