"""Port parity: the Vocos head (``nn/vocos.py``), EnCodec+Vocos and
WavTokenizer of ``audiocodecs_tpu_torch`` against the JAX package's on the
same weights (carried over by ``from_jax_params``) and the same numpy
inputs, on the CPU.

Tolerances: ``istft`` within 1e-5 · max|ref| (spectra whose DC and Nyquist
bins carry large imaginary parts, which both sides must ignore); one
ConvNeXt block, the backbone in its three norm forms and ``apply_vocos``
within 1e-5 · max|ref| (a few fp32 products in another order); the small
codecs: tokens identical, features and waveforms within 1e-4 · max|ref|.
Full published widths at B=1, 0.5 s: features within 1e-4 relative,
token_match ≥ 0.99 (large-codebook argmax margins can flip on last-ulp
differences), and the decode of the same tokens within 1e-4 · max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JEncConfig
from audiocodecs_tpu.models.wavtokenizer import WavTokenizer as JWavTokenizer
from audiocodecs_tpu.models.wavtokenizer import (
    WavTokenizerModelConfig as JWTConfig,
)
from audiocodecs_tpu.nn import vocos as jv
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.models.wavtokenizer import (
    WavTokenizer,
    WavTokenizerModelConfig,
    init_wavtokenizer_params,
)
from audiocodecs_tpu_torch.nn import vocos as tv
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params

SMALL_VOCOS = dict(input_channels=16, dim=32, intermediate_dim=64,
                   num_layers=2, n_fft=32, hop_length=8)
# tests/test_codec_zoo.py's small configs
ENC_SMALL = dict(sampling_rate=800, num_filters=4, hidden_size=16,
                 upsampling_ratios=(4, 2), codebook_size=32, codebook_dim=16,
                 num_quantizers=8)
WT_SMALL = dict(num_filters=8, hidden_size=32, upsampling_ratios=(4, 2),
                codebook_size=64, codebook_dim=32, vocos_dim=32,
                vocos_intermediate_dim=64, vocos_layers=2, n_fft=64,
                hop_length=8)


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), err


def _perturbed(tree, rng):
    """The reference's init with N(0, 0.1²) added to every leaf, so that
    γ, the norms and the AdaLN tables all move the output."""
    return jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(
        a.shape).astype(np.float32) * 0.1, tree)


def _vocos_pair(rng, form):
    """(JAX params, port module, call kwargs for each) in one norm form:
    "plain" LayerNorm, "cond_id" AdaLN, "cond" continuous AdaLN."""
    cfg = jv.VocosConfig(**SMALL_VOCOS, num_adanorm_embeddings=(
        None if form == "plain" else 4))
    if form == "cond":
        jp = jv.init_vocos_backbone_params(jax.random.PRNGKey(0), cfg,
                                           cond_dim=6)
        mod = tv.Vocos(tv.VocosConfig(**dataclasses.asdict(cfg)), head=False,
                       cond_dim=6)
    else:
        jp = jv.init_vocos_params(jax.random.PRNGKey(0), cfg)
        mod = tv.Vocos(tv.VocosConfig(**dataclasses.asdict(cfg)))
    jp = _perturbed(jp, rng)
    mod.load_state_dict(from_jax_params(jp, mod), strict=True)
    cond = rng.standard_normal((2, 6)).astype(np.float32)
    kw = {"plain": ({}, {}), "cond_id": ({"cond_id": 2}, {"cond_id": 2}),
          "cond": ({"cond": jnp.asarray(cond)},
                   {"cond": torch.from_numpy(cond)})}[form]
    return cfg, jp, mod, kw


@pytest.mark.parametrize("n_fft,hop", [(64, 16), (1280, 320)])
@pytest.mark.parametrize("padding", ["center", "same"])
def test_istft_matches_jax(rng, n_fft, hop, padding):
    half = n_fft // 2 + 1
    re = rng.standard_normal((2, 9, half)).astype(np.float32)
    im = rng.standard_normal((2, 9, half)).astype(np.float32)
    im[..., 0], im[..., -1] = 50.0, -50.0
    want = jv.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, padding)
    got = tv.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                   padding).numpy()
    assert got.shape == (2, 8 * hop if padding == "center" else 9 * hop)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("form", ["plain", "cond_id", "cond"])
def test_convnext_block_matches_jax(rng, form):
    cfg, jp, mod, (jkw, tkw) = _vocos_pair(rng, form)
    x = rng.standard_normal((2, 11, cfg.dim)).astype(np.float32)
    jcond_id, jcond = jkw.get("cond_id"), jkw.get("cond")
    want = jv._convnext_block(jnp.asarray(x), jp["blocks"][1], cfg, jcond_id,
                              jcond)
    with torch.no_grad():
        got = tv._convnext_block(torch.from_numpy(x), mod.blocks[1], mod.cfg,
                                 tkw.get("cond_id"), tkw.get("cond"))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("form", ["plain", "cond_id", "cond"])
def test_backbone_matches_jax(rng, form):
    cfg, jp, mod, (jkw, tkw) = _vocos_pair(rng, form)
    feats = rng.standard_normal((2, 13, 16)).astype(np.float32)
    want = jv.apply_vocos_backbone(jp, jnp.asarray(feats), cfg, **jkw)
    with torch.no_grad():
        got = tv.apply_vocos_backbone(mod, torch.from_numpy(feats), mod.cfg,
                                      **tkw)
    assert got.shape == (2, 13, 32)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("form", ["plain", "cond_id"])
def test_apply_vocos_matches_jax(rng, form):
    cfg, jp, mod, (jkw, tkw) = _vocos_pair(rng, form)
    feats = rng.standard_normal((2, 13, 16)).astype(np.float32)
    want = jv.apply_vocos(jp, jnp.asarray(feats), cfg, **jkw)
    with torch.no_grad():
        got = tv.apply_vocos(mod, torch.from_numpy(feats), mod.cfg, **tkw)
    assert got.shape == (2, 12 * 8)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("cond_dim", [None, 6])
def test_init_keys_match_the_reference_tree(cond_dim):
    cfg = jv.VocosConfig(**SMALL_VOCOS)
    want = set(flatten_tree(jax.tree.map(
        np.asarray, jv.init_vocos_backbone_params(jax.random.PRNGKey(0), cfg,
                                                  cond_dim=cond_dim))))
    pcfg = tv.VocosConfig(**SMALL_VOCOS)
    a = tv.init_vocos_backbone_params(torch.Generator().manual_seed(3), pcfg,
                                      cond_dim=cond_dim)
    b = tv.init_vocos_backbone_params(torch.Generator().manual_seed(3), pcfg,
                                      cond_dim=cond_dim)
    assert set(a) == want
    assert set(tv.Vocos(pcfg, head=False, cond_dim=cond_dim).state_dict()) \
        == want
    assert all(torch.equal(a[k], b[k]) for k in a)


# ----------------------------------------------------------------------- #
# EnCodec + Vocos
# ----------------------------------------------------------------------- #


def _encodec_vocos_pair(mode="reconstruct", small=True, seed=0):
    jcfg = JEncConfig(**ENC_SMALL) if small else JEncConfig()
    vc = jv.VocosConfig(**SMALL_VOCOS) if small else None
    sr = jcfg.sampling_rate
    jc = JEncodec(sr, sr, mode=mode, num_codebooks=8, use_vocos=True,
                  vocos_config=vc, model_config=jcfg,
                  key=jax.random.PRNGKey(seed))
    tc = Encodec(sr, sr, mode=mode, num_codebooks=8, use_vocos=True,
                 vocos_config=vc and tv.VocosConfig(**dataclasses.asdict(vc)),
                 model_config=EncodecModelConfig(**dataclasses.asdict(jcfg)),
                 device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def encodec_vocos():
    return _encodec_vocos_pair()


def test_encodec_vocos_matches_jax(encodec_vocos, rng):
    """K = 8 selects AdaLN row 2 (6 kbps) on both sides."""
    jc, tc = encodec_vocos
    assert tc._bandwidth_id == jc._bandwidth_id == 2
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    np.testing.assert_array_equal(tt, jt)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    jy = jc.toks_to_sig(jt)
    _close(tc.toks_to_sig(tt).numpy(), jy, 1e-4)
    # reconstruct mode: the same tokens, so the reference's decode of them
    _close(tc(sig).numpy(), jy, 1e-4)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_encodec_vocos_modes_prune_as_the_reference(mode):
    jc, tc = _encodec_vocos_pair(mode=mode, seed=1)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    assert not any(k.startswith("decoder.") for k in keys)
    assert (mode == "decode") == any(k.startswith("vocos.") for k in keys)


def test_encodec_vocos_head_has_its_own_stream():
    """The head's weights come from their own generator (seed 1, as the
    reference's ``PRNGKey(1)``), whatever generator draws the codec's."""
    mc = EncodecModelConfig(**ENC_SMALL)
    vc = tv.VocosConfig(**SMALL_VOCOS)
    a, b = (Encodec(800, 800, use_vocos=True, vocos_config=vc,
                    model_config=mc, device="cpu",
                    generator=torch.Generator().manual_seed(s))
            for s in (0, 5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa if k.startswith("vocos."))
    assert not torch.equal(sa["codebooks"], sb["codebooks"])


def test_encodec_vocos_full_width(rng):
    """The published EnCodec-24k encoder and ``VocosConfig()`` (384 wide, 8
    blocks, n_fft 1280) at B=1, 0.5 s."""
    jc, tc = _encodec_vocos_pair(small=False, seed=0)
    sig = (rng.standard_normal((1, 12000)) * 0.1).astype(np.float32)
    jf = np.asarray(jc.sig_to_feats(sig))
    _close(tc.sig_to_feats(sig).numpy(), jf, 1e-4)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 38, 8)
    assert (tt == jt).mean() >= 0.99
    _close(tc.toks_to_sig(jt).numpy(), jc.toks_to_sig(jt), 1e-4)


# ----------------------------------------------------------------------- #
# WavTokenizer
# ----------------------------------------------------------------------- #


def _wt_pair(mode="reconstruct", small=True, seed=0):
    jcfg = JWTConfig(**WT_SMALL) if small else JWTConfig()
    jc = JWavTokenizer(24000, 24000, mode=mode, model_config=jcfg,
                       key=jax.random.PRNGKey(seed))
    tc = WavTokenizer(24000, 24000, mode=mode, device="cpu",
                      model_config=WavTokenizerModelConfig(
                          **dataclasses.asdict(jcfg)))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


def test_wavtokenizer_matches_jax(rng):
    jc, tc = _wt_pair()
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == (2, 50, 1)
    np.testing.assert_array_equal(tt, jt)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    _close(tc.sig_to_qfeats(sig).numpy(), jc.toks_to_qfeats(jt), 1e-4)
    # the reference decodes with padding="center": (N − 1)·hop samples
    y = tc.toks_to_sig(tt).numpy()
    assert y.shape == (2, 49 * 8)
    _close(y, jc.toks_to_sig(jt), 1e-4)
    assert tc.embs().shape == (1, 64, 32)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_wavtokenizer_modes_and_refusal(mode):
    jc, tc = _wt_pair(mode=mode, seed=1)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    assert (mode == "encode") == (not any(k.startswith("vocos.")
                                          for k in keys))
    with pytest.raises(ValueError, match="single-codebook"):
        WavTokenizer(24000, num_codebooks=2, device="cpu",
                     model_config=tc.model_config)


def test_wavtokenizer_init_is_seeded_and_complete():
    mc = WavTokenizerModelConfig(**WT_SMALL)
    a = init_wavtokenizer_params(torch.Generator().manual_seed(5), mc)
    b = init_wavtokenizer_params(torch.Generator().manual_seed(5), mc)
    assert all(torch.equal(a[k], b[k]) for k in a)
    tc = WavTokenizer(24000, model_config=mc, state_dict=a, device="cpu")
    assert set(tc.state_dict()) == set(a)


def test_wavtokenizer_full_width(rng):
    """The published config (hidden 512, one 4096 × 512 codebook, Vocos 768
    wide, 12 blocks) at B=1, 0.5 s."""
    jc, tc = _wt_pair(small=False, seed=0)
    sig = (rng.standard_normal((1, 12000)) * 0.1).astype(np.float32)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 38, 1)
    assert (tt == jt).mean() >= 0.99
    _close(tc.toks_to_sig(jt).numpy(), jc.toks_to_sig(jt), 1e-4)


def test_bridge_layouts_of_the_head(rng):
    """embed ``[7, Cin, dim]`` → ``[dim, Cin, 7]``, depthwise ``[7, 1, dim]``
    → ``[dim, 1, 7]``; linears, γ and AdaLN tables unchanged."""
    _, jp, mod, _ = _vocos_pair(rng, "cond_id")
    sd = from_jax_params(jp, mod)
    np.testing.assert_array_equal(sd["embed.w"].numpy(),
                                  jp["embed"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["blocks.0.dwconv.w"].numpy(),
                                  jp["blocks"][0]["dwconv"]["w"]
                                  .transpose(2, 1, 0))
    for key, leaf in (("blocks.1.pw1.w", jp["blocks"][1]["pw1"]["w"]),
                      ("head.w", jp["head"]["w"]),
                      ("blocks.0.gamma", jp["blocks"][0]["gamma"]),
                      ("adanorm_in.scale", jp["adanorm_in"]["scale"])):
        np.testing.assert_array_equal(sd[key].numpy(), leaf)


@pytest.mark.parametrize("family", ["wavtokenizer", "encodec"])
def test_encodec_style_tier_changes_nothing_under_vocos(encodec_vocos, rng,
                                                        family):
    """WavTokenizer and EnCodec + Vocos decode through a Vocos head, which
    reads no activation dtype in the reference: under ``_ENCODEC_STYLE``'s
    switches the reference's decode is its exact one, bit for bit, and the
    port's tier codec decodes as its exact one, bit for bit, within 1e-4 of
    the reference."""
    from seanet_tier import reference_tier

    from audiocodecs_tpu_torch.serving import apply_serving_preset

    jc, tc = _wt_pair() if family == "wavtokenizer" else encodec_vocos
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    toks = np.asarray(jc.sig_to_toks(sig))
    j_exact = np.asarray(jc.toks_to_sig(toks))
    kw = apply_serving_preset(family)
    assert kw["decode_dtype"] == torch.bfloat16
    sr = tc.sample_rate
    extra = {} if family == "wavtokenizer" else dict(
        num_codebooks=8, use_vocos=True, vocos_config=tc.vocos_config)
    tier = type(tc)(sr, sr, model_config=tc.model_config, device="cpu",
                    state_dict=tc.state_dict(), **extra, **kw)
    with reference_tier(family):
        jt = type(jc)(sr, sr, model_config=jc.model_config, params=jc.params,
                      **({} if family == "wavtokenizer" else dict(
                          num_codebooks=8, use_vocos=True,
                          vocos_config=jc.vocos_config)))
        np.testing.assert_array_equal(np.asarray(jt.sig_to_toks(sig)), toks)
        j_tier = np.asarray(jt.toks_to_sig(toks))
    np.testing.assert_array_equal(j_tier, j_exact)
    np.testing.assert_array_equal(tier.sig_to_toks(sig).numpy(), toks)
    got = tier.toks_to_sig(toks)
    assert torch.equal(got, tc.toks_to_sig(toks))
    _close(got.numpy(), j_tier, 1e-4)
