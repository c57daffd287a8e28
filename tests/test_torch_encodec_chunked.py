"""Port parity: EnCodec's loudness normalization and the windowed chunking
of the 48 kHz model (``chunk_length_s``/``overlap``/``normalize``) in
``audiocodecs_tpu_torch`` against the JAX package's, on the same weights
and the same numpy inputs, on the CPU.

Tolerances: ``_chunk_frames`` exact (a copy); ``_linear_overlap_add``
within 1e-6 · max|ref| (the same fp32 adds); the small codecs (sr 800, hop
8, 320-sample windows, the shapes of ``tests/test_encodec_parity.py``'s
chunked test): tokens identical, features and waveforms within 1e-4 ·
max|ref|. The full-width 48 kHz-style config at B=1, 1.2 s (2 windows):
token_match ≥ 0.99 and the decode of the same tokens within 1e-4 ·
max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.models.encodec import (
    _linear_overlap_add as j_overlap_add,
)
from audiocodecs_tpu_torch.models.encodec import (
    Encodec,
    EncodecModelConfig,
    _linear_overlap_add,
)
from audiocodecs_tpu_torch.params import from_jax_params

SMALL = dict(sampling_rate=800, num_filters=4, hidden_size=16,
             upsampling_ratios=(4, 2), codebook_size=32, codebook_dim=16,
             num_quantizers=4)
# facebook/encodec_48khz's chunking, mono and without time group norm, as
# the JAX package defines the model
FULL_48K = dict(sampling_rate=48000, use_causal_conv=False, normalize=True,
                chunk_length_s=1.0, overlap=0.01, num_quantizers=16)


def _pair(cfg: dict, seed=0, num_codebooks=4):
    jcfg = JConfig(**cfg)
    sr = jcfg.sampling_rate
    jc = JEncodec(sr, sr, num_codebooks=num_codebooks, model_config=jcfg,
                  key=jax.random.PRNGKey(seed))
    tc = Encodec(sr, sr, num_codebooks=num_codebooks, device="cpu",
                 model_config=EncodecModelConfig(**dataclasses.asdict(jcfg)))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


def _close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), err


def _sig(rng, B, T, scale=2.0):
    return (rng.standard_normal((B, T)) * scale).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_normalize_without_chunking(rng, causal):
    """The RMS scale of the whole signal, in features, tokens and qfeats."""
    jc, tc = _pair(dict(SMALL, normalize=True, use_causal_conv=causal),
                   seed=1)
    sig = _sig(rng, 2, 777)
    jt = np.asarray(jc.sig_to_toks(sig))
    np.testing.assert_array_equal(tc.sig_to_toks(sig).numpy(), jt)
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)
    _close(tc.sig_to_qfeats(sig).numpy(), jc.toks_to_qfeats(jt), 1e-4)
    # reconstruct mode: the same tokens, so the reference's decode of them
    _close(tc(sig).numpy(), jc.toks_to_sig(jt), 1e-4)


@pytest.mark.parametrize("T,overlap", [(960, 0.0), (800, 0.25), (1, 0.25),
                                       (320, 0.5), (1000, 0.01)])
def test_chunk_frames_match_jax(rng, T, overlap):
    jc, tc = _pair(dict(SMALL, chunk_length_s=0.4, overlap=overlap))
    assert tc.model_config.chunk_stride == jc.model_config.chunk_stride
    sig = _sig(rng, 2, T)
    want = np.asarray(jc._chunk_frames(jnp.asarray(sig)))
    got = tc._chunk_frames(torch.from_numpy(sig)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,L,stride", [(3, 320, 320), (3, 320, 240),
                                        (4, 64, 17), (1, 50, 49)])
def test_linear_overlap_add_matches_jax(rng, n, L, stride):
    chunks = rng.standard_normal((2, n, L)).astype(np.float32)
    want = j_overlap_add(jnp.asarray(chunks), stride)
    got = _linear_overlap_add(torch.from_numpy(chunks), stride).numpy()
    assert got.shape == (2, stride * (n - 1) + L)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("overlap,T", [(0.0, 960), (0.25, 800)])
def test_chunked_roundtrip_matches_jax(rng, causal, overlap, T):
    """Normalized windows of 320 samples (40 frames) through one encoder
    call, decoded window by window and overlap-added."""
    jc, tc = _pair(dict(SMALL, chunk_length_s=0.4, overlap=overlap,
                        normalize=True, use_causal_conv=causal), seed=2)
    sig = _sig(rng, 2, T)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    n = max(1, -(-T // tc.model_config.chunk_stride))
    assert tt.shape == (2, 40 * n, 4)
    np.testing.assert_array_equal(tt, jt)
    _close(tc.sig_to_qfeats(sig).numpy(), jc.toks_to_qfeats(jt), 1e-4)
    y = tc.toks_to_sig(tt).numpy()
    assert y.shape == (2, tc.model_config.chunk_stride * (n - 1) + 320)
    jy = jc.toks_to_sig(jt)
    _close(y, jy, 1e-4)
    _close(tc.roundtrip(sig).numpy(), jy, 1e-4)
    # features and vocoding from features do not chunk, as in the reference
    _close(tc.sig_to_feats(sig).numpy(), jc.sig_to_feats(sig), 1e-4)


def test_chunked_decode_refuses_a_partial_window(rng):
    jc, tc = _pair(dict(SMALL, chunk_length_s=0.4, overlap=0.25))
    toks = rng.integers(0, 32, (1, 41, 4)).astype(np.int32)
    with pytest.raises(ValueError, match="divisible by 40"):
        jc.toks_to_sig(toks)
    with pytest.raises(ValueError, match="divisible by 40"):
        tc.toks_to_sig(toks)


def test_full_width_48k_chunked(rng):
    """48 kHz, 1 s windows at stride 47520: 1.2 s is 2 windows of 150
    frames; non-causal reflect-padded SEANet, LSTMs at H = 512, K = 8."""
    jc, tc = _pair(FULL_48K, num_codebooks=8)
    sig = _sig(rng, 1, 57600, scale=0.1)
    jt = np.asarray(jc.sig_to_toks(sig))
    tt = tc.sig_to_toks(sig).numpy()
    assert tt.shape == jt.shape == (1, 300, 8)
    assert (tt == jt).mean() >= 0.99
    y = tc.toks_to_sig(jt).numpy()
    assert y.shape == (1, 47520 + 48000)
    _close(y, jc.toks_to_sig(jt), 1e-4)
