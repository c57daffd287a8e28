"""Port parity: ``audiocodecs_tpu_torch`` BigCodec against the JAX package's
on the same weights (carried over by ``from_jax_params``) and the same numpy
inputs, on the CPU.

Small config (``tests/test_codec_zoo2.py``'s: ngf 4, ratios (2, 5),
dilations (1, 3), hidden 16, one 64 × 8 codebook, one LSTM layer at
H = 16) with weights redrawn so that every layer moves the output
(0.5/√fan_in convs and projections, α = |N| + 0.5, biases ≠ 0): tokens
identical, features, qfeats and waveforms within 1e-4 of their largest
magnitude (fp32 sums in another order). Full published width (ngf 48,
H = 1536 LSTMs, 8192 × 8 codebook) on a 1 s signal (T = 80 frames), the
reference's own init: features within 1e-4 relative, token_match ≥ 0.99.
The recurrence's plain version at H = 1536 against the reference's
``_scan_reference`` at atol 1e-5. The balanced serving tier (bf16 decoder
activations, polynomial snake, the LSTM an fp32 island) against the
reference's under the same switches, as ``tests/test_torch_dac.py`` holds
DAC's throughput tier.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.bigcodec import BigCodec as JBigCodec
from audiocodecs_tpu.models.bigcodec import BigCodecModelConfig as JConfig
from audiocodecs_tpu.ops.lstm_pallas import _scan_reference
from audiocodecs_tpu_torch.serving import apply_serving_preset
from audiocodecs_tpu_torch.models.bigcodec import (
    BigCodec,
    BigCodecModelConfig,
    init_bigcodec_params,
)
from audiocodecs_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_reference,
)
from audiocodecs_tpu_torch.params import (
    flatten_tree,
    from_jax_params,
    to_jax_params,
)

REL = 1e-4
SMALL = dict(ngf=4, up_ratios=(2, 5), dilations=(1, 3), hidden_size=16,
             codebook_size=64, codebook_dim=8, rnn_layers=1)


def _redraw(tree, seed):
    """Redraw every leaf of the reference's tree (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.tree.map(np.asarray, tree))

    def draw(key, a):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "w":  # conv [K, Cin, Cout] or projection [in, out]
            return rng.standard_normal(a.shape) * 0.5 / np.sqrt(
                np.prod(a.shape[:-1]))
        if leaf in ("w_ih", "w_hh"):
            return rng.uniform(-1, 1, a.shape) / np.sqrt(a.shape[1] / 4)
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


def _pair(mode="reconstruct", latent=True, small=True, params=None):
    jcfg = JConfig(**SMALL) if small else JConfig()
    if params is None:
        params = JBigCodec(16000, 16000, model_config=jcfg).params
        if small:
            params = _redraw(params, 0)
    jc = JBigCodec(16000, 16000, mode=mode, latent=latent, model_config=jcfg,
                   params=params)
    tc = BigCodec(16000, 16000, mode=mode, latent=latent,
                  model_config=BigCodecModelConfig(**dataclasses.asdict(jcfg)),
                  device="cpu")
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


def _sig(rng, B, T, scale=0.5):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("B,T,N", [(2, 400, 40), (1, 1234, 123)])
def test_small_tokens_identical_features_close(small_pair, rng, B, T, N):
    """Each strided conv (k = 2s, pad ⌈s/2⌉) floors: 1234 samples give 123
    frames, as in the reference."""
    jc, tc = small_pair
    sig = _sig(rng, B, T)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (B, N, 1)
    np.testing.assert_array_equal(tt, jt)
    _close(tc.sig_to_feats(sig), jc.sig_to_feats(sig))  # latent: in_proj
    _close(tc.sig_to_qfeats(sig), jc.sig_to_qfeats(sig))


def test_small_non_latent_features_and_embs(small_pair, rng):
    jc, tc = small_pair
    jfull, tfull = _pair(latent=False, params=jc.params)
    sig = _sig(rng, 2, 400)
    jf = np.asarray(jfull.sig_to_feats(sig))
    assert jf.shape == (2, 40, 16)
    _close(tfull.sig_to_feats(sig), jf)
    np.testing.assert_array_equal(tc.embs().numpy(), np.asarray(jc.embs()))
    assert tc.embs().shape == (1, 64, 8)
    _close(tfull.embs(), jfull.embs())
    assert tfull.embs().shape == (1, 64, 16)


@pytest.mark.parametrize("N", [40, 7])
def test_small_decode_close_on_same_tokens(small_pair, rng, N):
    jc, tc = small_pair
    toks = rng.integers(0, 64, (2, N, 1)).astype(np.int32)
    jy = np.asarray(jc.toks_to_sig(toks))
    ty = tc.toks_to_sig(toks).numpy()
    assert ty.shape == (2, N * 10)
    _close(ty, jy)
    _close(tc.toks_to_qfeats(toks), jc.toks_to_qfeats(toks))


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_drop_the_unused_half(small_pair, rng, mode):
    jc, tc = small_pair
    jm, tm = _pair(mode=mode, params=jc.params)
    keys = tm.state_dict()
    drop = "decoder." if mode == "encode" else "encoder."
    assert not any(k.startswith(drop) for k in keys)
    assert any(k.startswith("quantizer.") for k in keys)
    sig = _sig(rng, 1, 400)
    if mode == "encode":
        np.testing.assert_array_equal(tm(sig).numpy(),
                                      np.asarray(jc.sig_to_toks(sig)))
    else:
        toks = np.asarray(jc.sig_to_toks(sig))
        _close(tm(toks), jm.toks_to_sig(toks))


def test_to_jax_params_round_trip(small_pair):
    jc, tc = small_pair
    tree = jax.tree.map(np.asarray, jc.params)
    back = to_jax_params(tc.state_dict(), tc)
    a, b = flatten_tree(back), flatten_tree(tree)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])
    assert a["encoder.alpha_out"].shape == (1, 1, 16)
    sd = from_jax_params(back, tc)
    for k, v in tc.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_init_is_seeded_and_complete():
    cfg = BigCodecModelConfig(**SMALL)
    a = init_bigcodec_params(torch.Generator().manual_seed(0), cfg)
    b = init_bigcodec_params(torch.Generator().manual_seed(0), cfg)
    tc = BigCodec(16000, 16000, model_config=cfg, state_dict=a,
                  device="cpu")
    assert sorted(a) == sorted(tc.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="single-codebook"):
        BigCodec(16000, 16000, num_codebooks=2, model_config=cfg,
                 device="cpu")


def test_full_width_features_and_tokens(rng):
    """The published config at B = 1, 1 s: 80 frames through the encoder's
    two H = 1536 LSTM layers."""
    jc, tc = _pair(mode="encode", small=False)
    assert tuple(tc.encoder.rnn[0].w_hh.shape) == (1536, 6144)
    sig = _sig(rng, 1, 16000, scale=0.1)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 80, 8)
    _close(tf, jf)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 80, 1)
    assert (tt == jt).mean() >= 0.99


def test_recurrence_plain_version_at_h1536_matches_jax(rng):
    T, B, H = 6, 2, 1536
    gx = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    want = _scan_reference(*(jnp.asarray(a) for a in (gx, w_hh, h0, c0)))
    args = [torch.from_numpy(a) for a in (gx, w_hh, h0, c0)]
    got = lstm_recurrence(*args)  # CPU tensors: the plain version
    plain = lstm_recurrence_reference(*args)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_balanced_tier_matches_the_reference(small_pair, rng):
    from test_torch_dac import check_bf16_tier, reference_tier, unfused

    jc, tc = small_pair
    sig = _sig(rng, 2, 2000)
    toks = np.asarray(jc.sig_to_toks(sig))
    j_exact = np.asarray(jc.toks_to_sig(toks))
    t_exact = tc.toks_to_sig(toks).numpy()
    kw = apply_serving_preset("bigcodec")

    def port():
        return BigCodec(16000, 16000, model_config=tc.model_config,
                        state_dict=tc.state_dict(), device="cpu", **kw)

    def reference(fused):
        with reference_tier("bigcodec", "balanced", None, fused):
            jt = JBigCodec(16000, 16000, model_config=jc.model_config,
                           params=jc.params)  # a new instance: a fresh trace
            np.testing.assert_array_equal(np.asarray(jt.sig_to_toks(sig)),
                                          toks)
            return np.asarray(jt.toks_to_sig(toks))

    tt = port()
    np.testing.assert_array_equal(tt.sig_to_toks(sig).numpy(), toks)
    t_tier = tt.toks_to_sig(toks).numpy()
    assert tt.decoder.rnn[0].w_hh.dtype == torch.float32
    check_bf16_tier(t_tier, t_exact, reference(True), j_exact)
    check_bf16_tier(unfused(port()).toks_to_sig(toks).numpy(), t_exact,
                    reference(False), j_exact)
