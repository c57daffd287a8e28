"""Port parity: ``audiocodecs_tpu_torch`` SpeechTokenizer and its
bidirectional LSTM against the JAX package's, on the same weights (carried
over by ``from_jax_params``) and the same numpy inputs, on the CPU.

Tolerances: the BiLSTM at atol 1e-5 (fp32 sums in another order over a few
dozen steps). The small config (8 filters, latent 32, ratios (4, 2), 4 × 32
× 32 codebooks): tokens identical, features and waveforms within 1e-4 of
their largest magnitude. Full published width (16 kHz, H = 1024 LSTMs,
B = 1, 0.5 s): features within 1e-4 relative, token_match ≥ 0.99
(1024-entry argmax margins can flip on last-ulp differences).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.speechtokenizer import SpeechTokenizer as JST
from audiocodecs_tpu.models.speechtokenizer import (
    SpeechTokenizerModelConfig as JConfig,
)
from audiocodecs_tpu.nn.lstm import bilstm as j_bilstm
from audiocodecs_tpu.nn.lstm import init_bilstm_params as j_init_bilstm
from audiocodecs_tpu_torch.models.speechtokenizer import (
    SpeechTokenizer,
    SpeechTokenizerModelConfig,
    init_speechtokenizer_params,
)
from audiocodecs_tpu_torch.nn.lstm import BiLSTM, bilstm, init_bilstm_params
from audiocodecs_tpu_torch.nn.seanet import (
    SEANet,
    init_stream_state,
    seanet_encoder_plan,
)
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params

SMALL = dict(num_filters=8, hidden_size=32, upsampling_ratios=(4, 2),
             codebook_size=32, codebook_dim=32, num_quantizers=4)


def _pair(mode="reconstruct", num_codebooks=4, small=True, seed=0):
    jcfg = JConfig(**SMALL) if small else JConfig()
    jc = JST(16000, 16000, mode=mode, num_codebooks=num_codebooks,
             model_config=jcfg, key=jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jc.params)
    tc = SpeechTokenizer(16000, 16000, mode=mode, num_codebooks=num_codebooks,
                         model_config=SpeechTokenizerModelConfig(
                             **dataclasses.asdict(jcfg)),
                         device="cpu")
    tc.load_state_dict(from_jax_params(tree, tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def small_pair():
    return _pair()


def _sig(rng, B, T, scale=0.3):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("T", [1, 37])
def test_bilstm_matches_jax(rng, T):
    tree = jax.tree.map(np.asarray, j_init_bilstm(jax.random.PRNGKey(T), 2,
                                                   16, 16))
    model = BiLSTM(2, 16, 16)
    model.load_state_dict(from_jax_params(tree, model), strict=True)
    assert "1.bwd.w_ih" in model.state_dict()
    assert tuple(model[1].fwd.w_ih.shape) == (32, 64)  # layer 2 reads 2H
    x = rng.standard_normal((3, T, 16)).astype(np.float32)
    want = np.asarray(j_bilstm(jnp.asarray(x), tree))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, T, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bilstm_backward_half_sees_the_future(rng):
    """One layer: the forward half at t = 0 ignores the last input, the
    backward half does not."""
    params = init_bilstm_params(torch.Generator().manual_seed(0), 1, 16, 16)
    x = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    x2 = x.clone()
    x2[:, -1] = 0.0
    y, y2 = bilstm(x, params), bilstm(x2, params)
    torch.testing.assert_close(y[:, 0, :16], y2[:, 0, :16], rtol=0, atol=0)
    assert not torch.allclose(y[:, 0, 16:], y2[:, 0, 16:])


@pytest.mark.parametrize("B,T", [(2, 400), (1, 1999), (3, 80)])
def test_small_tokens_identical_features_close(small_pair, rng, B, T):
    jc, tc = small_pair
    sig = _sig(rng, B, T)
    j_toks = np.asarray(jc.sig_to_toks(sig))
    t_toks = tc.sig_to_toks(sig).numpy()
    assert t_toks.shape == j_toks.shape == (B, -(-T // 8), 4)
    np.testing.assert_array_equal(t_toks, j_toks)
    _rel_close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig))
    _rel_close(tc.sig_to_qfeats(sig).numpy(), jc.sig_to_qfeats(sig))


@pytest.mark.parametrize("N", [1, 50])
def test_small_decode_close_on_same_tokens(small_pair, rng, N):
    jc, tc = small_pair
    toks = rng.integers(0, 32, (2, N, 4)).astype(np.int32)
    _rel_close(tc.toks_to_sig(toks).numpy(), jc.toks_to_sig(toks))
    _rel_close(tc.toks_to_qfeats(toks).numpy(), jc.toks_to_qfeats(toks))
    feats = rng.standard_normal((2, N, 32)).astype(np.float32)
    _rel_close(tc.feats_to_sig(feats).numpy(), jc.feats_to_sig(feats))


def test_small_reconstruct_and_embs(small_pair, rng):
    jc, tc = small_pair
    sig = _sig(rng, 2, 800)
    _rel_close(tc(sig).numpy(), jc(sig))
    _rel_close(tc.roundtrip(sig).numpy(), jc(sig))
    np.testing.assert_array_equal(tc.embs().detach().numpy(),
                                  np.asarray(jc.embs()))


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_and_load_strict(rng, mode):
    jc, tc = _pair(mode=mode, seed=2)
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
        toks = rng.integers(0, 32, (1, 12, 4)).astype(np.int32)
        _rel_close(tc(toks).numpy(), jc(toks))


def test_init_is_seeded_and_complete():
    mc = SpeechTokenizerModelConfig(**SMALL)
    a = init_speechtokenizer_params(torch.Generator().manual_seed(5), mc)
    b = init_speechtokenizer_params(torch.Generator().manual_seed(5), mc)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    tc = SpeechTokenizer(16000, num_codebooks=3, model_config=mc,
                         state_dict=a, device="cpu")
    assert tc.embs().shape == (3, 32, 32)
    assert "encoder.7.1.bwd.w_hh" in a and "decoder.1.1.w_hh" in a


def test_bilstm_stack_refuses_streaming():
    """The backward direction needs the whole signal, as in the reference."""
    mc = SpeechTokenizerModelConfig(**SMALL, use_causal_conv=True)
    sea = mc.seanet(True)
    with pytest.raises(NotImplementedError, match="bilstm"):
        init_stream_state(SEANet(sea, seanet_encoder_plan(sea)), 1)


def test_full_width_features_and_tokens(rng):
    """The published config (64 filters, H = 1024 BiLSTM encoder, 8 × 1024
    × 1024 codebooks) at B = 1, 0.5 s."""
    jc, tc = _pair(mode="encode", num_codebooks=8, small=False, seed=0)
    assert tuple(getattr(tc.encoder, "13")[1].fwd.w_ih.shape) == (2048, 4096)
    sig = _sig(rng, 1, 8000, scale=0.1)
    jf = np.asarray(jc.sig_to_feats(sig))
    tf = tc.sig_to_feats(sig).numpy()
    assert tf.shape == jf.shape == (1, 25, 1024)
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 25, 8)
    assert (tt == jt).mean() >= 0.99


def _same_weights(jc, tc, K):
    """Makers of a fresh reference codec (a new trace) and of the port's,
    with ``tc``'s weights and the given constructor arguments."""
    sr = tc.sample_rate

    def make_j():
        return type(jc)(sr, sr, num_codebooks=K, model_config=jc.model_config,
                        params=jc.params)

    def make_t(**kw):
        return type(tc)(sr, sr, num_codebooks=K, model_config=tc.model_config,
                        state_dict=tc.state_dict(), device="cpu", **kw)

    return make_j, make_t


def test_serving_tier_matches_the_reference(small_pair, rng):
    """SpeechTokenizer's balanced tier: a bf16 decoder whose non-causal
    blocks take the unfused path and whose LSTM is an fp32 island, against
    the reference's under its switches (``_ENCODEC_STYLE`` and the wide
    decoder LSTM, which the port's recurrence kernel covers in every tier;
    ``tests/seanet_tier.py``)."""
    from seanet_tier import check_family_tier

    jc, tc = small_pair
    tt, _ = check_family_tier("speechtokenizer", jc, tc,
                              *_same_weights(jc, tc, 4), _sig(rng, 2, 2000))
    assert tt.decoder.form.dtype == torch.bfloat16 and tt.encoder.form.exact


def test_encode_precision_default_matches_the_reference(small_pair, rng):
    from seanet_tier import check_encode_precision

    jc, tc = small_pair
    check_encode_precision(jc, *_same_weights(jc, tc, 4), _sig(rng, 2, 2000))
