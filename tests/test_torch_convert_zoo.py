"""The port's vendor-checkpoint converters (the EnCodec lineage's SEANet
walker, SpeechTokenizer, PAST, the Vocos head, WavTokenizer, BigCodec)
against the JAX package's, on the JAX package's documented vendor schemas.

No vendor package or checkpoint is installed, so each case fills the JAX
schema with seeded values (``tests/test_zoo_converters.py``'s
``synth_state_dict`` at the small configs; the port's faster
``synth_state_dict`` at the published ones) and requires the port's
converter to give ``from_jax_params(audiocodecs_tpu.convert.zoo.…(sd),
port_model)``: the same keys, every tensor equal bit for bit, weight-norm
folds within 2 float32 ulp. The port's schemas equal the JAX package's, the
converters refuse a key they do not read where the JAX package's refuse it
and tolerate the EMA buffers, and a converted codec loads and runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiocodecs_tpu.convert import vendor_seanet as jax_vendor  # noqa: E402
from audiocodecs_tpu.convert import zoo as jax_zoo  # noqa: E402
from audiocodecs_tpu.models import bigcodec as jax_bigcodec  # noqa: E402
from audiocodecs_tpu.models import seanet_rvq as jax_seanet_rvq  # noqa: E402
from audiocodecs_tpu.models import speechtokenizer as jax_st  # noqa: E402
from audiocodecs_tpu.models import wavtokenizer as jax_wt  # noqa: E402
from audiocodecs_tpu.nn import seanet as jax_seanet  # noqa: E402
from audiocodecs_tpu.nn import vocos as jax_vocos  # noqa: E402
from audiocodecs_tpu_torch.convert import vendor_seanet, zoo  # noqa: E402
from audiocodecs_tpu_torch.convert.torch_utils import (  # noqa: E402
    synth_state_dict as fast_synth,
)
from audiocodecs_tpu_torch.models.bigcodec import (  # noqa: E402
    BigCodec,
    BigCodecModelConfig,
)
from audiocodecs_tpu_torch.models.past import PAST  # noqa: E402
from audiocodecs_tpu_torch.models.seanet_rvq import SEANetRVQConfig  # noqa: E402
from audiocodecs_tpu_torch.models.speechtokenizer import (  # noqa: E402
    SpeechTokenizer,
    SpeechTokenizerModelConfig,
)
from audiocodecs_tpu_torch.models.wavtokenizer import (  # noqa: E402
    WavTokenizer,
    WavTokenizerModelConfig,
)
from audiocodecs_tpu_torch.nn.seanet import SEANetConfig  # noqa: E402
from audiocodecs_tpu_torch.nn.vocos import Vocos, VocosConfig  # noqa: E402
from audiocodecs_tpu_torch.params import (  # noqa: E402
    flatten_tree,
    from_jax_params,
)
from test_zoo_converters import synth_state_dict  # noqa: E402
from zoo_pairs import assert_same_state, one_thread  # noqa: E402,F401


def _wn_conv(k: str) -> bool:
    return k.endswith(".w")


def _jax_cfg(jax_cls, port_cfg):
    """The JAX package's twin of a port config (the same fields)."""
    return jax_cls(**{f.name: getattr(port_cfg, f.name)
                      for f in dataclasses.fields(port_cfg)})


# (port config, JAX config class, port codec class, port converter, JAX
# converter, port schema, JAX schema) by family; small and published
_SMALL_SEANET = dict(sampling_rate=800, num_filters=4, hidden_size=16,
                     upsampling_ratios=(4, 2), codebook_size=16,
                     codebook_dim=16)


def _family(name: str, published: bool):
    if name == "speechtokenizer":
        cfg = (SpeechTokenizerModelConfig() if published else
               SpeechTokenizerModelConfig(num_quantizers=4, **_SMALL_SEANET))
        return (cfg, jax_st.SpeechTokenizerModelConfig, SpeechTokenizer,
                zoo.convert_speechtokenizer_state_dict,
                jax_zoo.convert_speechtokenizer_state_dict,
                zoo.speechtokenizer_schema, jax_zoo.speechtokenizer_schema)
    if name == "past":
        cfg = (PAST.default_model_config() if published else
               SEANetRVQConfig(num_quantizers=4, use_causal_conv=True,
                               **_SMALL_SEANET))
        return (cfg, jax_seanet_rvq.SEANetRVQConfig, PAST,
                zoo.convert_past_state_dict, jax_zoo.convert_past_state_dict,
                zoo.past_schema, jax_zoo.past_schema)
    if name == "wavtokenizer":
        cfg = (WavTokenizerModelConfig() if published else
               WavTokenizerModelConfig(vocos_dim=8, vocos_intermediate_dim=16,
                                       vocos_layers=2, n_fft=16,
                                       hop_length=8, **_SMALL_SEANET))
        return (cfg, jax_wt.WavTokenizerModelConfig, WavTokenizer,
                zoo.convert_wavtokenizer_state_dict,
                jax_zoo.convert_wavtokenizer_state_dict,
                zoo.wavtokenizer_schema, jax_zoo.wavtokenizer_schema)
    if name == "bigcodec":
        cfg = (BigCodecModelConfig() if published else
               BigCodecModelConfig(ngf=4, up_ratios=(2, 5), dilations=(1, 3),
                                   hidden_size=16, codebook_size=32,
                                   codebook_dim=8, rnn_layers=1))
        return (cfg, jax_bigcodec.BigCodecModelConfig, BigCodec,
                zoo.convert_bigcodec_state_dict,
                jax_zoo.convert_bigcodec_state_dict, zoo.bigcodec_schema,
                jax_zoo.bigcodec_schema)
    raise ValueError(name)


def _synth(schema, synth):
    if "CodecEnc" in schema:  # BigCodec's two-part checkpoint
        return {part: synth(s, seed=i)
                for i, (part, s) in enumerate(schema.items())}
    return synth(schema)


def _codec(cls, cfg, sd):
    sr = cfg.sampling_rate
    kw = {} if cls in (WavTokenizer, BigCodec) else {"num_codebooks": 2}
    return cls(sr, sr, model_config=cfg, state_dict=sd, device="cpu", **kw)


_FAMILIES = ["speechtokenizer", "past", "wavtokenizer", "bigcodec"]


@pytest.mark.parametrize("published", [False, True],
                         ids=["small", "published"])
@pytest.mark.parametrize("name", _FAMILIES)
def test_matches_the_jax_converter(name, published):
    cfg, jax_cls, cls, port, ref, _, jax_schema = _family(name, published)
    jcfg = _jax_cfg(jax_cls, cfg)
    sd = _synth(jax_schema(jcfg), fast_synth if published else
                synth_state_dict)
    got = port(sd, cfg)
    codec = _codec(cls, cfg, got)
    want = from_jax_params(ref(sd, jcfg), codec)
    del codec
    assert_same_state(got, want, folded=_wn_conv)


@pytest.mark.parametrize("published", [False, True],
                         ids=["small", "published"])
@pytest.mark.parametrize("name", _FAMILIES)
def test_schema_is_the_jax_packages(name, published):
    cfg, jax_cls, *_, schema, jax_schema = _family(name, published)
    assert schema(cfg) == jax_schema(_jax_cfg(jax_cls, cfg))


@pytest.mark.parametrize("published", [False, True],
                         ids=["small", "published"])
@pytest.mark.parametrize("adanorm", [None, 4], ids=["layernorm", "adanorm"])
def test_vocos_head_matches_the_jax_converter(adanorm, published):
    """The Vocos head alone (charactr/vocos-encodec-24khz's AdaLN over 4
    bandwidths, or WavTokenizer's LayerNorm), under a ``root`` prefix."""
    cfg = (VocosConfig(input_channels=128, num_adanorm_embeddings=adanorm)
           if published else
           VocosConfig(input_channels=16, dim=8, intermediate_dim=16,
                       num_layers=2, n_fft=16, hop_length=8,
                       num_adanorm_embeddings=adanorm))
    jcfg = _jax_cfg(jax_vocos.VocosConfig, cfg)
    schema = zoo.vocos_schema(cfg, root="head_model.")
    assert schema == jax_zoo.vocos_schema(jcfg, root="head_model.")
    sd = (fast_synth if published else synth_state_dict)(schema)
    got = zoo.convert_vocos_state_dict(sd, cfg, root="head_model.")
    head = Vocos(cfg)
    head.load_state_dict(got, strict=True)
    want = from_jax_params(
        jax_zoo.convert_vocos_state_dict(sd, jcfg, root="head_model."), head)
    assert_same_state(got, want)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_vendor_seanet_schema_and_walker(bidirectional):
    """One stack at a root, with the BiLSTM's ``_reverse`` keys and without
    shortcuts, into the port's keys under another name."""
    cfg = SEANetConfig(num_filters=4, hidden_size=8, ratios=(2, 2),
                       lstm_bidirectional=bidirectional,
                       use_conv_shortcut=False)
    jcfg = _jax_cfg(jax_seanet.SEANetConfig, cfg)
    schema = vendor_seanet.vendor_seanet_schema(cfg, "a.b")
    assert schema == jax_vendor.vendor_seanet_schema(jcfg, "a.b")
    assert any(k.endswith("_reverse") for k in schema) == bidirectional
    sd = synth_state_dict(schema)
    out = {}
    vendor_seanet.convert_vendor_seanet(out, sd, cfg, "a.b", dst="enc")
    flat = flatten_tree(jax_vendor.convert_vendor_seanet(sd, jcfg, "a.b"))
    assert sorted(out) == sorted(f"enc.{k}" for k in flat)
    for k, a in flat.items():
        w = out[f"enc.{k}"]
        if k.endswith(".w"):  # a folded conv, [K, Cin, Cout] there
            np.testing.assert_array_max_ulp(w, a.transpose(2, 1, 0),
                                            maxulp=2)
        else:
            assert w.tobytes() == np.ascontiguousarray(a).tobytes(), k
    assert vendor_seanet.rvq_schema(3, 16, 8) == jax_vendor.rvq_schema(3, 16,
                                                                       8)


@pytest.mark.parametrize("name", _FAMILIES)
def test_unmapped_key_raises_and_ema_buffers_pass(name):
    cfg, jax_cls, cls, port, ref, schema, _ = _family(name, False)
    jcfg = _jax_cfg(jax_cls, cfg)
    sd = _synth(schema(cfg), synth_state_dict)
    flat = sd["CodecEnc"] if name == "bigcodec" else sd
    # the EMA buffers of a vendor VQ are tolerated without a schema entry
    flat["quantizer.vq.layers.9._codebook.embed_avg"] = np.zeros(
        (4, 4), np.float32)
    port(sd, cfg)
    ref(sd, jcfg)
    flat["transform.weight"] = np.zeros((4, 4), np.float32)  # drifted key
    with pytest.raises(ValueError, match="unmapped.*transform.weight"):
        port(sd, cfg)
    with pytest.raises(ValueError, match="unmapped"):
        ref(sd, jcfg)


@pytest.mark.parametrize("name", _FAMILIES)
def test_missing_key_raises(name):
    cfg, jax_cls, cls, port, ref, schema, _ = _family(name, False)
    sd = _synth(schema(cfg), synth_state_dict)
    flat = sd["generator"] if name == "bigcodec" else sd
    key = next(k for k in flat if k.endswith("weight_v"))
    del flat[key]
    with pytest.raises(KeyError):
        port(sd, cfg)
    with pytest.raises(KeyError):
        ref(sd, _jax_cfg(jax_cls, cfg))


@pytest.mark.parametrize("name", _FAMILIES)
def test_converted_codec_runs(name):
    """A converted small codec loads strictly and roundtrips to a finite
    waveform of the input's frames."""
    cfg, _, cls, port, _, schema, _ = _family(name, False)
    codec = _codec(cls, cfg, port(_synth(schema(cfg), fast_synth), cfg))
    sig = np.random.default_rng(0).standard_normal((2, 400)).astype(
        np.float32)
    with torch.no_grad():
        y = codec.roundtrip(sig)
    assert y.shape[0] == 2 and bool(torch.isfinite(y).all())


def test_bigcodec_alpha_and_projections_are_flattened():
    """Snake ``α [1, C, 1]`` → ``[C]``; the quantizer's weight-normed 1×1
    convs → ``[H, D]``/``[D, H]`` matrices."""
    cfg = _family("bigcodec", False)[0]
    ckpt = _synth(zoo.bigcodec_schema(cfg), synth_state_dict)
    got = zoo.convert_bigcodec_state_dict(ckpt, cfg)
    gen = ckpt["generator"]
    assert np.array_equal(got["decoder.alpha_out"].numpy(),
                          gen["conv_final_block.0.alpha"].reshape(-1))
    assert got["quantizer.in_proj.w"].shape == (cfg.hidden_size,
                                                cfg.codebook_dim)
    assert got["quantizer.out_proj.w"].shape == (cfg.codebook_dim,
                                                 cfg.hidden_size)
