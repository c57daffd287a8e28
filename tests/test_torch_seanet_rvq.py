"""Port parity: ``rvq_quantize``/``rvq_quantize_stats``, the generic
SEANet-RVQ codec (with and without its projector) and PAST of
``audiocodecs_tpu_torch`` against the JAX package's, on the same weights and
the same numpy inputs, on the CPU.

Tolerances: the quantizers' tokens and counts identical, ``q``, ``sums`` and
``residuals`` within 1e-5 · max|ref| (the same fp32 adds and one product in
another order); the small codecs: tokens identical, features and waveforms
within 1e-4 · max|ref|; PAST streamed chunk by chunk against the JAX
package's stream: tokens identical, waveform within 1e-4 · max|ref|. PAST
at full width (B=1, 0.5 s): features within 1e-4 relative, token_match ≥
0.99, the decode of the same tokens within 1e-4 · max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.past import PAST as JPAST
from audiocodecs_tpu.models.seanet_rvq import SEANetRVQCodec as JCodec
from audiocodecs_tpu.models.seanet_rvq import SEANetRVQConfig as JConfig
from audiocodecs_tpu.quant.rvq import rvq_quantize as j_quantize
from audiocodecs_tpu.quant.rvq import rvq_quantize_stats as j_stats
from audiocodecs_tpu_torch.models.past import PAST
from audiocodecs_tpu_torch.models.seanet_rvq import (
    SEANetRVQCodec,
    SEANetRVQConfig,
    init_seanet_rvq_params,
)
from audiocodecs_tpu_torch.params import flatten_tree, from_jax_params
from audiocodecs_tpu_torch.quant.rvq import rvq_quantize, rvq_quantize_stats

SMALL = dict(sampling_rate=800, num_filters=4, hidden_size=16,
             upsampling_ratios=(4, 2), codebook_size=32, num_quantizers=4)


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.mark.parametrize("K", [None, 3])
def test_rvq_quantize_matches_jax(rng, K):
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    cb = rng.standard_normal((5, 32, 16)).astype(np.float32)
    jt, jq = j_quantize(jnp.asarray(x), jnp.asarray(cb), K)
    tt, tq = rvq_quantize(torch.from_numpy(x), torch.from_numpy(cb), K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _close(tq.numpy(), jq, 1e-5)


@pytest.mark.parametrize("K", [None, 3])
def test_rvq_quantize_stats_matches_jax(rng, K):
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    cb = rng.standard_normal((5, 32, 16)).astype(np.float32)
    want = j_stats(jnp.asarray(x), jnp.asarray(cb), K)
    got = rvq_quantize_stats(torch.from_numpy(x), torch.from_numpy(cb), K)
    k = K or 5
    shapes = [(2, 37, k), (2, 37, 16), (k, 32), (k, 32, 16), (k, 74, 16)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in (1, 3, 4):
        _close(got[i].numpy(), want[i], 1e-5)
    assert float(got[2].sum()) == k * 74


def test_rvq_quantize_stats_detaches_the_statistics(rng):
    x = torch.from_numpy(rng.standard_normal((1, 5, 4)).astype(np.float32))
    x.requires_grad_(True)
    cb = torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32))
    _, q, counts, sums, res = rvq_quantize_stats(x, cb)
    assert not (counts.requires_grad or sums.requires_grad
                or res.requires_grad)


def _pair(cfg: dict, cls=(JCodec, SEANetRVQCodec), mode="reconstruct",
          seed=0, K=3):
    jcfg = JConfig(**cfg)
    sr = jcfg.sampling_rate
    jc = cls[0](sr, sr, mode=mode, num_codebooks=K, model_config=jcfg,
                key=jax.random.PRNGKey(seed))
    tc = cls[1](sr, sr, mode=mode, num_codebooks=K, device="cpu",
                model_config=SEANetRVQConfig(**dataclasses.asdict(jcfg)))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.mark.parametrize("codebook_dim", [16, 8])
def test_codec_matches_jax(rng, codebook_dim):
    """codebook_dim 8 ≠ hidden 16: 1×1 projector convs either side."""
    jc, tc = _pair(dict(SMALL, codebook_dim=codebook_dim), seed=1)
    assert tc.model_config.has_projector == (codebook_dim != 16)
    assert hasattr(tc, "in_proj") == tc.model_config.has_projector
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == (2, 50, 3)
    np.testing.assert_array_equal(tt, jt)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    _close(tc.sig_to_qfeats(sig).numpy(), jc.toks_to_qfeats(jt), 1e-4)
    _close(tc.toks_to_sig(tt).numpy(), jc.toks_to_sig(jt), 1e-4)
    feats = rng.standard_normal((2, 7, 16)).astype(np.float32)
    _close(tc.feats_to_sig(feats).numpy(), jc.feats_to_sig(feats), 1e-4)
    assert tuple(tc.embs().shape) == (3, 32, codebook_dim)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_modes_prune_the_projectors(mode):
    jc, tc = _pair(dict(SMALL, codebook_dim=8), mode=mode, seed=2)
    keys = set(tc.state_dict())
    assert set(flatten_tree(jax.tree.map(np.asarray, jc.params))) == keys
    kept, dropped = (("in_proj.w", "out_proj.w") if mode == "encode"
                     else ("out_proj.w", "in_proj.w"))
    assert kept in keys and dropped not in keys


def test_bridge_turns_the_projectors_into_1x1_convs():
    jc, tc = _pair(dict(SMALL, codebook_dim=8), seed=5)
    tree = jax.tree.map(np.asarray, jc.params)
    sd = from_jax_params(tree, tc)
    np.testing.assert_array_equal(sd["in_proj.w"].numpy(),
                                  tree["in_proj"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["out_proj.w"].numpy(),
                                  tree["out_proj"]["w"].transpose(2, 1, 0))
    assert tuple(sd["in_proj.w"].shape) == (8, 16, 1)


def test_init_is_seeded_and_complete():
    mc = SEANetRVQConfig(**SMALL, codebook_dim=8)
    a = init_seanet_rvq_params(torch.Generator().manual_seed(5), mc)
    b = init_seanet_rvq_params(torch.Generator().manual_seed(5), mc)
    assert all(torch.equal(a[k], b[k]) for k in a)
    tc = SEANetRVQCodec(800, 800, model_config=mc, state_dict=a,
                        device="cpu")
    assert set(tc.state_dict()) == set(a)


def _past_small(streamable=True):
    base = dataclasses.asdict(JPAST.default_model_config(
        800, streamable=streamable))
    base.update(num_filters=4, hidden_size=16, upsampling_ratios=(4, 2),
                codebook_size=32, codebook_dim=16, num_quantizers=4)
    return base


@pytest.mark.parametrize("streamable", [True, False])
def test_past_matches_jax(rng, streamable):
    cfg = _past_small(streamable)
    assert cfg["use_causal_conv"] == streamable
    jc, tc = _pair(cfg, cls=(JPAST, PAST), seed=3)
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    jt = np.asarray(jc.sig_to_toks(sig))
    np.testing.assert_array_equal(tc.sig_to_toks(sig).numpy(), jt)
    _close(tc.toks_to_sig(jt).numpy(), jc.toks_to_sig(jt), 1e-4)
    assert PAST.default_model_config() == SEANetRVQConfig(
        **dataclasses.asdict(JPAST.default_model_config()))


@pytest.mark.parametrize("codebook_dim", [16, 8])
def test_past_streaming_matches_jax_streaming(rng, codebook_dim):
    """Three chunks of 3 frames through encode_chunk then decode_chunk on
    both sides (one chunk size: the JAX package traces each size anew)."""
    jc, tc = _pair(dict(_past_small(), codebook_dim=codebook_dim),
                   cls=(JPAST, PAST), seed=4)
    step = tc.frame_size * 3
    assert tc.frame_size == jc.frame_size == 8
    sig = (rng.standard_normal((2, step * 3)) * 0.3).astype(np.float32)
    states = [tc.init_streaming_state(2), tc.init_streaming_state(2),
              jc.init_streaming_state(2), jc.init_streaming_state(2)]
    toks, wav, jtoks, jwav = [], [], [], []
    for pos in range(0, sig.shape[1], step):
        chunk = sig[:, pos:pos + step]
        t, states[0] = tc.encode_chunk(chunk, states[0])
        w, states[1] = tc.decode_chunk(t, states[1])
        jt, states[2] = jc.encode_chunk(jnp.asarray(chunk), states[2])
        jw, states[3] = jc.decode_chunk(jt, states[3])
        toks.append(t.numpy())
        wav.append(w.numpy())
        jtoks.append(np.asarray(jt))
        jwav.append(np.asarray(jw))
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))
    _close(np.concatenate(wav, 1), np.concatenate(jwav, 1), 1e-4)


def test_past_full_width(rng):
    """The published PAST config (16 kHz, 32 filters, LSTMs at H = 512,
    8 × 1024 × 128 codebooks) at B=1, 0.5 s."""
    jcfg = JPAST.default_model_config()
    jc = JPAST(16000, 16000, num_codebooks=8, key=jax.random.PRNGKey(0))
    tc = PAST(16000, 16000, num_codebooks=8, device="cpu")
    assert tc.model_config == SEANetRVQConfig(**dataclasses.asdict(jcfg))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    sig = (rng.standard_normal((1, 8000)) * 0.1).astype(np.float32)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 25, 8)
    assert (tt == jt).mean() >= 0.99
    _close(tc.toks_to_sig(jt).numpy(), jc.toks_to_sig(jt), 1e-4)


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


@pytest.mark.parametrize("streamable", [True, False])
def test_past_serving_tier_matches_the_reference(rng, streamable):
    """PAST's balanced tier (bf16 decoder; the streamable variant's causal
    blocks on B2's one-pass form, the other's unfused) against the
    reference's under ``_ENCODEC_STYLE``'s switches
    (``tests/seanet_tier.py``)."""
    from seanet_tier import check_family_tier

    jc, tc = _pair(_past_small(streamable), cls=(JPAST, PAST), seed=3)
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    tt, _ = check_family_tier("past", jc, tc, *_same_weights(jc, tc, 3), sig,
                              fused=streamable)
    assert tt.decoder.form.dtype == torch.bfloat16 and tt.encoder.form.exact


def test_past_encode_precision_default_matches_the_reference(rng):
    from seanet_tier import check_encode_precision

    jc, tc = _pair(_past_small(), cls=(JPAST, PAST), seed=3)
    sig = (rng.standard_normal((2, 400)) * 0.3).astype(np.float32)
    check_encode_precision(jc, *_same_weights(jc, tc, 3), sig)


def test_past_streaming_in_a_tier(rng):
    """Streaming reads no activation dtype (the reference's streaming path
    neither): the bf16 tier streams as the exact codec does; a one-pass
    fp32 encoder refuses to stream."""
    jc, tc = _pair(dict(_past_small(), pad_mode="constant"),
                   cls=(JPAST, PAST), seed=3)
    make_t = _same_weights(jc, tc, 3)[1]
    sig = (rng.standard_normal((1, 4 * tc.frame_size)) * 0.3).astype(
        np.float32)
    tier = make_t(decode_dtype=torch.bfloat16, decode_precision="default")
    state_t, state_e = (c.init_streaming_state(1) for c in (tier, tc))
    toks, _ = tc.encode_chunk(sig, state_e)
    y_t, _ = tier.decode_chunk(toks, state_t)
    y_e, _ = tc.decode_chunk(toks, state_e)
    assert torch.equal(y_t, y_e)
    one_pass = make_t(encode_precision="default")
    with pytest.raises(NotImplementedError, match="one-pass"):
        one_pass.encode_chunk(sig, one_pass.init_streaming_state(1))
