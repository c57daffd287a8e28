"""Port parity: ``audiocodecs_tpu_torch`` DAC against the JAX package's on
the same weights (carried over by ``from_jax_params``) and the same numpy
inputs, on the CPU.

Small config (2 ratios, 8 encoder filters, decoder 32 → 8, hidden 16,
4 codebooks of 64 × 8) with weights redrawn so that every layer moves the
output (0.5/√fan_in convs, α = |N| + 0.5, biases ≠ 0): tokens
identical, features, qfeats and waveforms at atol 1e-5 (fp32 sums in
another order). Full published width (44.1 kHz, 9 codebooks, B = 1 × 4410
samples, the reference's own init): features within 1e-4 relative,
token_match ≥ 0.99.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.dac import DAC as JDAC
from audiocodecs_tpu.models.dac import DACModelConfig as JConfig
from audiocodecs_tpu_torch.models.dac import (
    DAC,
    DACModelConfig,
    ResidualUnit,
    init_dac_params,
)
from audiocodecs_tpu_torch.ops.dac_resunit import dac_resunit
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params

ATOL = 1e-5
SMALL = dict(encoder_hidden_size=8, downsampling_ratios=(2, 2),
             decoder_hidden_size=32, upsampling_ratios=(2, 2), hidden_size=16,
             n_codebooks=4, codebook_size=64, codebook_dim=8)


def _redraw(tree, seed):
    """Redraw every leaf of the reference's tree (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, tree))

    def draw(key, a):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "w":  # [K, Cin, Cout]
            return rng.standard_normal(a.shape) * 0.5 / np.sqrt(
                a.shape[0] * a.shape[1])
        if leaf.startswith("alpha"):
            return np.abs(rng.standard_normal(a.shape)) + 0.5
        return rng.standard_normal(a.shape) * (0.1 if leaf == "b" else 1.0)

    new = {k: jnp.asarray(draw(k, a), jnp.float32) for k, a in flat.items()}

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, f"{prefix}.{i}") for i, v in enumerate(node)]
        return new[prefix]

    return rebuild(tree, "")


def _pair(mode="reconstruct", sample_rate=16000, num_codebooks=4,
          latent=False, seed=0):
    jcfg = JConfig(**SMALL)
    params = _redraw(JDAC(16000, 16000, model_config=jcfg).params, seed)
    jc = JDAC(sample_rate, 16000, mode=mode, num_codebooks=num_codebooks,
              latent=latent, model_config=jcfg, params=params)
    tc = DAC(sample_rate, 16000, mode=mode, num_codebooks=num_codebooks,
             latent=latent,
             model_config=DACModelConfig(**dataclasses.asdict(jcfg)),
             device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


def _sig(rng, B, T, scale=0.3):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


@pytest.mark.parametrize("B,T", [(2, 2000), (1, 1999), (3, 301), (1, 4)])
def test_tokens_identical_and_features_close(small_pair, rng, B, T):
    jc, tc = small_pair
    sig = _sig(rng, B, T)
    j_toks = np.asarray(jc.sig_to_toks(sig))
    t_toks = tc.sig_to_toks(sig).numpy()
    assert t_toks.shape == j_toks.shape
    np.testing.assert_array_equal(t_toks, j_toks)
    jf = np.asarray(jc.sig_to_feats(sig))
    assert np.abs(jf).max() > 0.1  # the redrawn weights reach the output
    np.testing.assert_allclose(tc.sig_to_feats(sig).numpy(), jf, atol=ATOL)
    np.testing.assert_allclose(tc.sig_to_qfeats(sig).numpy(),
                               np.asarray(jc.sig_to_qfeats(sig)), atol=ATOL)


@pytest.mark.parametrize("N", [1, 37, 250])
def test_decode_close_on_same_tokens(small_pair, rng, N):
    jc, tc = small_pair
    toks = rng.integers(0, 64, (2, N, 4)).astype(np.int32)
    want = np.asarray(jc.toks_to_sig(toks))
    assert want.shape == (2, 4 * N) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(tc.toks_to_sig(toks).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tc.toks_to_qfeats(toks).numpy(),
                               np.asarray(jc.toks_to_qfeats(toks)), atol=ATOL)
    feats = rng.standard_normal((2, N, 16)).astype(np.float32)
    np.testing.assert_allclose(tc.feats_to_sig(feats).numpy(),
                               np.asarray(jc.feats_to_sig(feats)), atol=ATOL)


def test_reconstruct_roundtrip_and_logits(small_pair, rng):
    jc, tc = small_pair
    sig = _sig(rng, 2, 1600)
    want = np.asarray(jc(sig))
    np.testing.assert_allclose(tc(sig).numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), want, atol=ATOL)
    jl, tl = np.asarray(jc.logits()), tc.logits().numpy()
    assert tl.shape == jl.shape == (4, 64, 64)
    np.testing.assert_array_equal(np.isinf(tl), np.isinf(jl))
    finite = np.isfinite(jl)
    np.testing.assert_allclose(tl[finite], jl[finite], atol=1e-4)


@pytest.mark.parametrize("latent", [False, True])
def test_latent_flag_feats_and_embs(rng, latent):
    jc, tc = _pair(latent=latent, seed=1)
    sig = _sig(rng, 2, 900)
    jf = np.asarray(jc.sig_to_feats(sig))
    assert jf.shape == (2, 225, 8 if latent else 16)
    np.testing.assert_allclose(tc.sig_to_feats(sig).numpy(), jf, atol=ATOL)
    je, te = np.asarray(jc.embs()), tc.embs().numpy()
    assert te.shape == je.shape == ((4, 64, 8) if latent else (4, 64, 16))
    np.testing.assert_allclose(te, je, atol=ATOL)


def test_other_input_rate_matches(rng):
    """24 kHz in and out: resampling composes around the 16 kHz model."""
    jc, tc = _pair(sample_rate=24000, seed=2)
    sig = _sig(rng, 2, 1500)
    np.testing.assert_array_equal(tc.sig_to_toks(sig).numpy(),
                                  np.asarray(jc.sig_to_toks(sig)))
    np.testing.assert_allclose(tc.roundtrip(sig).numpy(), np.asarray(jc(sig)),
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_and_load_strict(rng, mode):
    jc, tc = _pair(mode=mode, seed=3)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    assert (mode == "encode") == (not any(k.startswith("decoder.")
                                          for k in keys))
    assert (mode == "decode") == (not any(k.startswith("encoder.")
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
    np.testing.assert_array_equal(
        sd["encoder.blocks.0.res.1.conv1.w"].numpy(),
        tree["encoder"]["blocks"][0]["res"][1]["conv1"]["w"].transpose(2, 1,
                                                                       0))
    # pre-flipped transposed conv → PyTorch's [Cin, Cout, K]
    np.testing.assert_array_equal(
        sd["decoder.blocks.1.convtr.w"].numpy(),
        np.flip(tree["decoder"]["blocks"][1]["convtr"]["w"], 0).transpose(
            1, 2, 0))
    np.testing.assert_array_equal(sd["quantizer.3.codebook"].numpy(),
                                  tree["quantizer"][3]["codebook"])
    np.testing.assert_array_equal(sd["encoder.blocks.1.alpha_down"].numpy(),
                                  tree["encoder"]["blocks"][1]["alpha_down"])
    del tree["decoder"]["blocks"][0]["res"][2]["alpha2"]
    with pytest.raises(KeyError):
        from_jax_params(tree, tc)


def test_init_is_seeded_and_complete():
    mc = DACModelConfig(**SMALL)
    a = init_dac_params(torch.Generator().manual_seed(5), mc)
    b = init_dac_params(torch.Generator().manual_seed(5), mc)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["decoder.blocks.0.res.0.conv1.w"].std()) == pytest.approx(
        0.02, rel=0.1)
    assert not a["encoder.conv_in.b"].any()
    assert (a["encoder.alpha_out"] == 1).all()
    tc = DAC(16000, num_codebooks=4, model_config=mc, state_dict=a,
             device="cpu")
    assert tc.embs().shape == (4, 64, 16)


@pytest.mark.parametrize("rate", [16000, 24000, 44100])
def test_default_model_config_matches_reference(rate):
    want = dataclasses.asdict(JDAC.default_model_config(rate))
    assert dataclasses.asdict(DAC.default_model_config(rate)) == want


@pytest.fixture(scope="module")
def full_pair():
    """The published 44.1 kHz config, the reference's init from one key."""
    jc = JDAC(44100, 44100, num_codebooks=9, key=jax.random.PRNGKey(0))
    tc = DAC(44100, 44100, num_codebooks=9, device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


def test_kernel_gate_is_decoder_units_up_to_256_channels(full_pair):
    _, tc = full_pair
    units = {n: m for n, m in tc.named_modules()
             if isinstance(m, ResidualUnit)}
    assert len(units) == 24
    fused = sorted((n, m.conv1.w.shape[0]) for n, m in units.items()
                   if m.fused)
    assert [c for _, c in fused] == [192] * 3 + [96] * 3
    assert all(n.startswith("decoder.blocks.") for n, _ in fused)
    assert {m.conv1.w.shape[0] for m in units.values() if not m.fused} == {
        64, 128, 256, 512, 768, 384}


def test_full_width_features_tokens_and_shapes(full_pair, rng):
    jc, tc = full_pair
    sig = _sig(rng, 1, 4410, scale=0.1)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 8, 1024)
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 8, 9)
    assert (tt == jt).mean() >= 0.99
    before = dac_resunit.launches
    y = tc.toks_to_sig(tt).numpy()
    assert dac_resunit.launches == before  # CPU tensors: the plain version
    want = np.asarray(jc.toks_to_sig(tt))
    assert y.shape == want.shape == (1, 4096)
    assert np.abs(y - want).max() <= 1e-4 * np.abs(want).max()
