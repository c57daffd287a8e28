"""The port's converters of SemantiCodec's pieces (AudioMAE, the HiFi-GAN
vocoder, the AutoencoderKL, the UNet, ``split_ldm_checkpoint``, the
assembly of the codec from its released parts) and of WavLM+K-means'
HiFi-GAN vocoder, against the JAX package's.

Each case fills the JAX package's documented vendor schema with seeded
values (``tests/test_zoo_converters.py``'s ``synth_state_dict``) at the
tiny LDM config of ``tests/test_torch_semanticodec.py`` and requires the
port's converter to give ``from_jax_params(<the JAX converter>(sd),
port_module)`` (the port module built on the meta device): the same keys,
every tensor equal bit for bit, weight-norm folds within 2 float32 ulp.
The schemas equal the JAX package's at the tiny and the published configs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiocodecs_tpu.convert import audiomae as jax_audiomae  # noqa: E402
from audiocodecs_tpu.convert import ldm as jax_ldm  # noqa: E402
from audiocodecs_tpu.convert import zoo as jax_zoo  # noqa: E402
from audiocodecs_tpu.models.semanticodec import (  # noqa: E402
    SemantiCodec as JSemantiCodec,
)
from audiocodecs_tpu.models.wavlm_kmeans import (  # noqa: E402
    WavLMKmeansModelConfig as JWKConfig,
)
from audiocodecs_tpu_torch.convert import audiomae, ldm, zoo  # noqa: E402
from audiocodecs_tpu_torch.convert.torch_utils import (  # noqa: E402
    synth_state_dict as fast_synth,
)
from audiocodecs_tpu_torch.models.semanticodec import (  # noqa: E402
    SemantiCodec,
    SemantiCodecModelConfig,
    init_semanticodec_params,
)
from audiocodecs_tpu_torch.models.wavlm_kmeans import (  # noqa: E402
    WavLMKmeans,
    WavLMKmeansModelConfig,
)
from audiocodecs_tpu_torch.nn.audiomae import AudioMAE  # noqa: E402
from audiocodecs_tpu_torch.nn.hifigan import HiFiGAN  # noqa: E402
from audiocodecs_tpu_torch.nn.ldm_unet import UNet  # noqa: E402
from audiocodecs_tpu_torch.nn.ldm_vae import AutoencoderKL  # noqa: E402
from audiocodecs_tpu_torch.params import (  # noqa: E402
    from_jax_params,
    to_jax_params,
)
from test_torch_semanticodec import TINY_LDM  # noqa: E402
from test_torch_zoo_wavlm import WK_SMALL  # noqa: E402
from test_zoo_converters import synth_state_dict  # noqa: E402
from zoo_pairs import (  # noqa: E402,F401
    assert_same_state,
    meta_codec,
    one_thread,
    port_config,
)

SR = 16000
CFG = port_config(SemantiCodecModelConfig, TINY_LDM)
PUBLISHED = JSemantiCodec.default_model_config()


def _folded(k: str) -> bool:
    return k.endswith(".w")


def _meta(cls, cfg):
    with torch.device("meta"):
        return cls(cfg)


# (port converter, JAX converter, port schema, JAX schema, port module,
# the config's field) of each piece
_PIECES = {
    "audiomae": (audiomae.convert_audiomae_state_dict,
                 jax_audiomae.convert_audiomae_state_dict,
                 audiomae.audiomae_schema, jax_audiomae.audiomae_schema,
                 AudioMAE, lambda c: c.audiomae()),
    "hifigan": (ldm.convert_hifigan_state_dict,
                jax_ldm.convert_hifigan_state_dict, ldm.hifigan_schema,
                jax_ldm.hifigan_schema, HiFiGAN, lambda c: c.vocoder_cfg),
    "vae": (ldm.convert_vae_state_dict, jax_ldm.convert_vae_state_dict,
            ldm.vae_schema, jax_ldm.vae_schema, AutoencoderKL,
            lambda c: c.vae_cfg),
    "unet": (ldm.convert_unet_state_dict, jax_ldm.convert_unet_state_dict,
             ldm.unet_schema, jax_ldm.unet_schema, UNet, lambda c: c.unet()),
}


@pytest.mark.parametrize("piece", list(_PIECES))
def test_matches_the_jax_converter(piece):
    port, ref, schema, _, module, part = _PIECES[piece]
    cfg, jcfg = part(CFG), part(TINY_LDM)
    sd = synth_state_dict(schema(cfg))
    got = port(sd, cfg)
    want = from_jax_params(ref(sd, jcfg), _meta(module, cfg))
    assert_same_state(got, want, folded=_folded)


@pytest.mark.parametrize("published", [False, True],
                         ids=["small", "published"])
@pytest.mark.parametrize("piece", list(_PIECES))
def test_schema_is_the_jax_packages(piece, published):
    *_, schema, jax_schema, _, part = _PIECES[piece]
    jcfg = PUBLISHED if published else TINY_LDM
    cfg = port_config(SemantiCodecModelConfig, jcfg)
    assert schema(part(cfg)) == jax_schema(part(jcfg))


def test_audiomae_reads_a_nested_encoder():
    """``prefix``: the encoder's keys inside a larger checkpoint; the
    patch conv becomes a linear over flattened patches, the class token
    and positions lose their batch axis."""
    cfg = CFG.audiomae()
    sd = synth_state_dict(audiomae.audiomae_schema(cfg, "model.encoder."))
    sd["model.decoder.extra"] = np.zeros((2,), np.float32)  # not read
    got = audiomae.convert_audiomae_state_dict(sd, cfg, "model.encoder.")
    want = jax_audiomae.convert_audiomae_state_dict(sd, TINY_LDM.audiomae(),
                                                    "model.encoder.")
    assert_same_state(got, from_jax_params(want, _meta(AudioMAE, cfg)))
    w = sd["model.encoder.patch_embed.proj.weight"]
    assert np.array_equal(got["patch_embed.w"].numpy(),
                          w.reshape(w.shape[0], -1).T)


@pytest.mark.parametrize("piece", ["hifigan", "vae", "unet"])
def test_unmapped_key_raises(piece):
    port, ref, schema, _, _, part = _PIECES[piece]
    sd = synth_state_dict(schema(part(CFG)))
    sd["mystery.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="unmapped.*mystery"):
        port(sd, part(CFG))
    with pytest.raises(ValueError, match="unmapped"):
        ref(sd, part(TINY_LDM))


def _ldm_checkpoint(cfg, seed=0, scale=0.5):
    """A whole LDM checkpoint: the VAE and the UNet under their prefixes,
    the scale, and the keys ``split_ldm_checkpoint`` drops (EMA shadows,
    the loss net, the DDPM schedule)."""
    sd = {f"first_stage_model.{k}": v for k, v in
          fast_synth(ldm.vae_schema(cfg.vae_cfg), seed).items()}
    sd.update({f"model.diffusion_model.{k}": v for k, v in
               fast_synth(ldm.unet_schema(cfg.unet()), seed + 1).items()})
    sd.update({"scale_factor": np.float32(scale),
               "model_ema.decay": np.float32(0.999),
               "first_stage_model.loss.logvar": np.zeros((), np.float32),
               "betas": np.zeros((4,), np.float32),
               "cond_stage_model.w": np.zeros((2,), np.float32)})
    return sd


def test_split_ldm_checkpoint_is_the_jax_packages():
    sd = _ldm_checkpoint(CFG)
    got, want = ldm.split_ldm_checkpoint(sd), jax_ldm.split_ldm_checkpoint(sd)
    assert {p: sorted(v) for p, v in got.items()} == \
        {p: sorted(v) for p, v in want.items()}
    assert "loss.logvar" not in got["vae"] and len(got["unet"]) > 10


def _pieces(cfg, seed=0):
    rng = np.random.default_rng(seed)
    H = cfg.feature_dim
    return dict(
        audiomae_sd=fast_synth(audiomae.audiomae_schema(cfg.audiomae()),
                               seed),
        centroids=rng.standard_normal((cfg.semantic_vocab, H)).astype(
            np.float32),
        acoustic_codebook=rng.standard_normal((cfg.acoustic_vocab, H)).astype(
            np.float32),
        ldm_sd=_ldm_checkpoint(cfg, seed),
        vocoder_sd=fast_synth(ldm.hifigan_schema(cfg.vocoder_cfg), seed + 2))


def test_semanticodec_components_match_the_jax_package():
    """Every piece into a base (the port's seeded init), against the JAX
    package's assembly on the same base: the codec's whole state dict."""
    base = init_semanticodec_params(torch.Generator().manual_seed(3), CFG)
    pieces = _pieces(CFG)
    got = zoo.convert_semanticodec_components(CFG, base_params=base,
                                              **pieces)
    codec = meta_codec(SemantiCodec, SR, SR, model_config=CFG,
                       state_dict=got)
    want = jax_zoo.convert_semanticodec_components(
        TINY_LDM, base_params=to_jax_params(base, codec), **pieces)
    assert_same_state(got, from_jax_params(want, codec), folded=_folded)
    assert float(got["latent_scale"]) == 0.5
    assert got["latent_scale"].shape == ()


def test_semanticodec_missing_pieces_keep_the_base():
    base = init_semanticodec_params(torch.Generator().manual_seed(3), CFG)
    pieces = _pieces(CFG)
    got = zoo.convert_semanticodec_components(
        CFG, base_params=base, centroids=pieces["centroids"])
    assert sorted(got) == sorted(base)
    for k, v in base.items():
        want = pieces["centroids"] if k == "semantic_codebook" else v.numpy()
        assert np.array_equal(got[k].numpy(), want), k
    default = zoo.convert_semanticodec_components(CFG)
    assert_same_state(default, init_semanticodec_params(
        torch.Generator().manual_seed(0), CFG))


def test_semanticodec_components_check_what_they_take():
    pieces = _pieces(CFG)
    with pytest.raises(ValueError, match="centroid_npy shape"):
        zoo.convert_semanticodec_components(
            CFG, base_params={}, centroids=pieces["centroids"][:, :-1])
    with pytest.raises(ValueError, match="acoustic codebook shape"):
        zoo.convert_semanticodec_components(
            CFG, base_params={},
            acoustic_codebook=pieces["acoustic_codebook"][1:])
    ldm_sd = dict(pieces["ldm_sd"])
    del ldm_sd["scale_factor"]
    with pytest.raises(ValueError, match="scale_factor"):
        zoo.convert_semanticodec_components(CFG, base_params={},
                                            ldm_sd=ldm_sd)
    with pytest.raises(ValueError, match="scale_factor"):
        zoo.convert_semanticodec_ldm_state_dict(ldm_sd, CFG)
    with pytest.raises(ValueError, match="scale_factor"):
        jax_zoo.convert_semanticodec_ldm_state_dict(ldm_sd, TINY_LDM)


def test_semanticodec_command_line_adapters():
    """The LDM file → ``vae.*``, ``unet.*``, ``latent_scale`` (from a
    config of the analog variant too); the vocoder file → ``vocoder.*``:
    the components' pieces."""
    pieces = _pieces(CFG)
    whole = zoo.convert_semanticodec_components(
        CFG, base_params={}, ldm_sd=pieces["ldm_sd"],
        vocoder_sd=pieces["vocoder_sd"])
    analog = dataclasses.replace(CFG, decoder_variant="analog")
    dec = zoo.convert_semanticodec_ldm_state_dict(pieces["ldm_sd"], analog)
    voc = zoo.convert_semanticodec_vocoder_state_dict(pieces["vocoder_sd"],
                                                      CFG)
    assert_same_state({**dec, **voc}, whole)


def test_converted_semanticodec_runs():
    """The codec assembled from converted pieces loads strictly and
    roundtrips one window to a finite waveform."""
    sd = zoo.convert_semanticodec_components(CFG, **_pieces(CFG))
    codec = SemantiCodec(SR, SR, model_config=CFG, state_dict=sd,
                         device="cpu")
    sig = np.random.default_rng(0).standard_normal((1, 3200)).astype(
        np.float32) * np.float32(0.1)
    y = codec.roundtrip(sig)
    assert y.shape[0] == 1 and bool(torch.isfinite(y).all())


def _speechbrain(schema: dict) -> dict:
    """speechbrain's wrapped convs: an inner ``.conv`` before each leaf."""
    out = {}
    for k, shape in schema.items():
        stem, leaf = k.rsplit(".", 1)
        out[f"{stem}.conv.{leaf}"] = shape
    return out


@pytest.mark.parametrize("nested", [False, True],
                         ids=["jik876", "speechbrain"])
def test_wavlm_kmeans_vocoder_matches_the_jax_converter(nested):
    """WavLM+K-means' HiFi-GAN unit vocoder in either naming → the
    variant's ``vocoder.*``; the codec loads it and decodes."""
    jcfg = dataclasses.replace(WK_SMALL, vocoder_variant="hifigan")
    cfg = port_config(WavLMKmeansModelConfig, jcfg)
    schema = ldm.hifigan_schema(cfg.hifigan())
    sd = synth_state_dict(_speechbrain(schema) if nested else schema)
    got = zoo.convert_wavlm_kmeans_vocoder(sd, cfg.hifigan())
    want = jax_zoo.convert_wavlm_kmeans_vocoder(sd, jcfg.hifigan())
    assert_same_state(got, from_jax_params(want, _meta(HiFiGAN,
                                                       cfg.hifigan())),
                      folded=_folded)
    codec = WavLMKmeans(SR, SR, model_config=cfg, device="cpu")
    state = {**codec.state_dict(),
             **{f"vocoder.{k}": v for k, v in got.items()}}
    codec = WavLMKmeans(SR, SR, model_config=cfg, state_dict=state,
                        device="cpu")
    y = codec.toks_to_sig(np.zeros((1, 4, len(cfg.layer_ids)), np.int64))
    assert bool(torch.isfinite(y).all())


def test_wavlm_kmeans_vocoder_defaults_to_the_variants_hifigan():
    cfg = WavLMKmeansModelConfig(vocoder_variant="hifigan").hifigan()
    schema = ldm.hifigan_schema(cfg)
    assert schema == jax_ldm.hifigan_schema(
        JWKConfig(vocoder_variant="hifigan").hifigan())
    got = zoo.convert_wavlm_kmeans_vocoder(fast_synth(schema))
    assert sorted(got) == sorted(_meta(HiFiGAN, cfg).state_dict())
