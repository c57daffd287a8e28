"""Port parity: ``audiocodecs_tpu_torch`` EnCodec against the JAX package's
on the same weights (carried over by ``from_jax_params``) and the same
numpy inputs, on the CPU.

Small config (2 ratios, 8 filters → LSTM H=32, 4 codebooks of 64 × 16):
tokens identical, features and waveforms at atol 1e-5 (fp32 sums in another
order through ~10 layers). Full published width (24 kHz, B=1, 0.5 s):
features within 1e-4 relative, token_match ≥ 0.99 (1024-entry argmax
margins can flip on last-ulp differences).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.resample import resample as j_resample
from audiocodecs_tpu_torch.models.encodec import (
    Encodec,
    EncodecModelConfig,
    init_encodec_params,
    prune_params_for_mode,
)
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params
from audiocodecs_tpu_torch.resample import resample

ATOL = 1e-5
SMALL = dict(num_filters=8, hidden_size=16, upsampling_ratios=(4, 2),
             codebook_size=64, codebook_dim=16, num_quantizers=4)


def _pair(mode="reconstruct", sample_rate=24000, num_codebooks=4, small=True,
          seed=0):
    jcfg = JConfig(**SMALL) if small else JConfig()
    jc = JEncodec(sample_rate, 24000, mode=mode, num_codebooks=num_codebooks,
                  model_config=jcfg, key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jc.params)
    tc = Encodec(sample_rate, 24000, mode=mode, num_codebooks=num_codebooks,
                 model_config=EncodecModelConfig(**dataclasses.asdict(jcfg)),
                 device="cpu")
    tc.load_state_dict(from_jax_params(tree, tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


def _sig(rng, B, T, scale=0.3):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


@pytest.mark.parametrize("B,T", [(2, 2000), (1, 1999), (3, 300), (1, 8)])
def test_tokens_identical_and_features_close(small_pair, rng, B, T):
    jc, tc = small_pair
    sig = _sig(rng, B, T)
    j_toks = np.asarray(jc.sig_to_toks(sig))
    t_toks = tc.sig_to_toks(sig).numpy()
    assert t_toks.shape == j_toks.shape == (B, -(-T // 8), 4)
    np.testing.assert_array_equal(t_toks, j_toks)
    np.testing.assert_allclose(tc.sig_to_feats(sig).numpy(),
                               np.asarray(jc.sig_to_feats(sig)), atol=ATOL)
    np.testing.assert_allclose(tc.sig_to_qfeats(sig).numpy(),
                               np.asarray(jc.sig_to_qfeats(sig)), atol=ATOL)


@pytest.mark.parametrize("N", [1, 37, 250])
def test_decode_close_on_same_tokens(small_pair, rng, N):
    jc, tc = small_pair
    toks = rng.integers(0, 64, (2, N, 4)).astype(np.int32)
    np.testing.assert_allclose(tc.toks_to_sig(toks).numpy(),
                               np.asarray(jc.toks_to_sig(toks)), atol=ATOL)
    np.testing.assert_allclose(tc.toks_to_qfeats(toks).numpy(),
                               np.asarray(jc.toks_to_qfeats(toks)), atol=ATOL)
    feats = rng.standard_normal((2, N, 16)).astype(np.float32)
    np.testing.assert_allclose(tc.feats_to_sig(feats).numpy(),
                               np.asarray(jc.feats_to_sig(feats)), atol=ATOL)


def test_reconstruct_and_roundtrip(small_pair, rng):
    jc, tc = small_pair
    sig = _sig(rng, 2, 1600)
    want = np.asarray(jc(sig))
    np.testing.assert_allclose(tc(sig).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), want, atol=ATOL)


def test_logits_match(small_pair):
    jc, tc = small_pair
    want = np.asarray(jc.logits())
    got = tc.logits().numpy()
    assert got.shape == want.shape == (4, 64, 64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=ATOL)


def test_token_resample_top1_matches(small_pair, rng):
    """p=1 and top_k=1 leave one candidate: the nearest other codeword."""
    jc, tc = small_pair
    toks = rng.integers(0, 64, (2, 9, 4)).astype(np.int32)
    want = np.asarray(jc.resample(jnp.asarray(toks), jax.random.PRNGKey(3),
                                  p=1.0, top_k=1))
    got = tc.resample(toks, torch.Generator().manual_seed(3), p=1.0, top_k=1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != toks).all()


@pytest.mark.parametrize("kw", [dict(p=0.5), dict(p=0.7, top_k=4),
                                dict(p=0.7, top_p=0.5, temp=0.5)])
def test_token_resample_is_seeded_and_in_vocab(small_pair, rng, kw):
    _, tc = small_pair
    toks = rng.integers(0, 64, (2, 30, 4))
    a = tc.resample(toks, torch.Generator().manual_seed(1), **kw)
    b = tc.resample(toks, torch.Generator().manual_seed(1), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (2, 30, 4) and 0 <= int(a.min()) and int(a.max()) < 64
    changed = float((a.numpy() != toks).mean())
    assert 0.0 < changed <= kw["p"] + 0.15


def test_other_input_rate_matches(rng):
    """16 kHz in and out: resampling composes around the 24 kHz model."""
    jc, tc = _pair(sample_rate=16000, seed=1)
    sig = _sig(rng, 2, 1333)
    np.testing.assert_array_equal(tc.sig_to_toks(sig).numpy(),
                                  np.asarray(jc.sig_to_toks(sig)))
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), np.asarray(jc(sig)),
                               atol=ATOL)


@pytest.mark.parametrize("orig,new,T", [(16000, 24000, 1000),
                                        (24000, 16000, 999),
                                        (44100, 24000, 441), (8000, 8000, 10)])
def test_resample_matches(rng, orig, new, T):
    x = _sig(rng, 2, T, scale=1.0)
    np.testing.assert_allclose(resample(torch.from_numpy(x), orig, new).numpy(),
                               np.asarray(j_resample(jnp.asarray(x), orig, new)),
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_and_load_strict(rng, mode):
    jc, tc = _pair(mode=mode, seed=2)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    assert (mode == "encode") == (not any(k.startswith("decoder.")
                                          for k in keys))
    if mode == "encode":
        sig = _sig(rng, 1, 640)
        np.testing.assert_array_equal(tc(sig).numpy(), np.asarray(jc(sig)))
    else:
        toks = rng.integers(0, 64, (1, 12, 4)).astype(np.int32)
        np.testing.assert_allclose(tc(toks).numpy(), np.asarray(jc(toks)),
                                   atol=ATOL)


def test_bridge_layouts_and_strictness():
    jc, tc = _pair(seed=4)
    tree = jax.tree.map(np.asarray, jc.params)
    sd = from_jax_params(tree, tc)
    # conv [K, Cin, Cout] → [Cout, Cin, K]; pre-flipped convtr → [Cin, Cout, K]
    np.testing.assert_array_equal(sd["encoder.0.w"].numpy(),
                                  tree["encoder"]["0"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        sd["decoder.3.w"].numpy(),
        np.flip(tree["decoder"]["3"]["w"], 0).transpose(1, 2, 0))
    np.testing.assert_array_equal(sd["encoder.7.1.w_hh"].numpy(),
                                  tree["encoder"]["7"][1]["w_hh"])
    del tree["encoder"]["0"]["b"]
    with pytest.raises(KeyError):
        from_jax_params(tree, tc)


def test_init_is_seeded_and_complete():
    mc = EncodecModelConfig(**SMALL)
    a = init_encodec_params(torch.Generator().manual_seed(5), mc)
    b = init_encodec_params(torch.Generator().manual_seed(5), mc)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    enc = prune_params_for_mode(a, "encode")
    assert not any(k.startswith("decoder.") for k in enc)
    tc = Encodec(24000, num_codebooks=4, model_config=mc, state_dict=a,
                 device="cpu")
    assert tc.embs().shape == (4, 64, 16)


@pytest.mark.parametrize("kw", [
    dict(use_vocos=True, num_codebooks=8, chunk_length_s=0.4),
    dict(use_vocos=True, num_codebooks=3)])
def test_refuses_what_the_reference_refuses(kw):
    """Vocos does not compose with windowed chunking, and takes only the
    bandwidths it has AdaLN rows for (K ∈ {2, 4, 8, 16})."""
    kw = dict(kw)
    chunk = kw.pop("chunk_length_s", None)
    cfg = dict(SMALL, sampling_rate=800, chunk_length_s=chunk)
    with pytest.raises(ValueError):
        JEncodec(800, 800, model_config=JConfig(**cfg), **kw)
    with pytest.raises(ValueError):
        Encodec(800, 800, model_config=EncodecModelConfig(**cfg),
                device="cpu", **kw)


def test_full_width_features_and_tokens(rng):
    """The published 24 kHz config (H=512 LSTMs, 32×1024×128 codebooks, 8
    used) at B=1, 0.5 s."""
    jc, tc = _pair(num_codebooks=8, small=False, seed=0)
    sig = _sig(rng, 1, 12000, scale=0.1)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 38, 128)
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 38, 8)
    assert (tt == jt).mean() >= 0.99


def _same_weights(jc, tc):
    """Makers of a fresh reference codec (a new trace) and of the port's
    with ``tc``'s weights and the given constructor arguments."""
    def make_j():
        return JEncodec(24000, 24000, num_codebooks=4,
                        model_config=jc.model_config, params=jc.params)

    def make_t(**kw):
        return Encodec(24000, 24000, num_codebooks=4,
                       model_config=tc.model_config,
                       state_dict=tc.state_dict(), device="cpu", **kw)

    return make_j, make_t


def test_serving_tier_matches_the_reference(small_pair, rng):
    """EnCodec's balanced tier (bf16 decoder, its causal blocks on B2's
    one-pass form) against the reference's under ``_ENCODEC_STYLE``'s
    switches (``tests/seanet_tier.py``); the LSTM stays an fp32 island."""
    from seanet_tier import check_family_tier

    jc, tc = small_pair
    tt, _ = check_family_tier("encodec", jc, tc, *_same_weights(jc, tc),
                              _sig(rng, 2, 2000), fused=True)
    assert tt.decoder.form.dtype == torch.bfloat16
    assert tt.encoder.form.exact
    assert getattr(tt.decoder, "1")[0].w_hh.dtype == torch.float32


def test_encode_precision_default_matches_the_reference(small_pair, rng):
    from seanet_tier import check_encode_precision

    jc, tc = small_pair
    check_encode_precision(jc, *_same_weights(jc, tc), _sig(rng, 2, 2000))
