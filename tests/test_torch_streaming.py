"""Port parity for streaming: the chunked conv primitives and EnCodec's
chunked encode/decode of ``audiocodecs_tpu_torch`` against the JAX package's
on the same weights and chunks, and chunked against batch in the port, on
the CPU.

Tolerances: the primitives at atol 1e-5; chunked EnCodec against batch with
zero padding, and against the JAX package's streaming, as the JAX package's
own streaming tests hold it: tokens identical, waveform atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.models.encodec import Encodec as JEncodec
from audiocodecs_tpu.models.encodec import EncodecModelConfig as JConfig
from audiocodecs_tpu.nn.streaming import conv_stream as j_conv_stream
from audiocodecs_tpu.nn.streaming import convtr_stream as j_convtr_stream
from audiocodecs_tpu.nn.streaming import init_conv_state as j_init_conv
from audiocodecs_tpu.nn.streaming import init_convtr_state as j_init_convtr
from audiocodecs_tpu_torch.models.encodec import Encodec, EncodecModelConfig
from audiocodecs_tpu_torch.nn.layers import ConvTranspose1d
from audiocodecs_tpu_torch.nn.streaming import (
    conv_stream,
    convtr_stream,
    init_conv_state,
    init_convtr_state,
)
from audiocodecs_tpu_torch.params import from_jax_params

ATOL = 1e-5
# the JAX package's constant-pad EnCodec streaming config
CONST = dict(sampling_rate=800, num_filters=4, hidden_size=16,
             upsampling_ratios=(4, 2), codebook_size=32, codebook_dim=16,
             num_quantizers=4, pad_mode="constant")


def _pair(cfg: dict, seed: int):
    jcfg = JConfig(**cfg)
    sr = jcfg.sampling_rate
    jc = JEncodec(sr, sr, num_codebooks=4, model_config=jcfg,
                  key=jax.random.PRNGKey(seed))
    tc = Encodec(sr, sr, num_codebooks=4, device="cpu",
                 model_config=EncodecModelConfig(**dataclasses.asdict(jcfg)))
    tc.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jc.params),
                                       tc), strict=True)
    return jc, tc


@pytest.fixture(scope="module")
def const_pair():
    return _pair(CONST, seed=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.mark.parametrize("k,stride,dilation", [(7, 1, 1), (3, 1, 2),
                                               (4, 2, 1), (1, 1, 1)])
def test_conv_stream_matches_jax(rng, k, stride, dilation):
    B, cin, cout = 2, 5, 3
    w = rng.standard_normal((k, cin, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal(cout).astype(np.float32)
    js = j_init_conv(B, k, stride, cin, dilation)
    ts = init_conv_state(B, k, stride, cin, dilation)
    assert tuple(ts.shape) == (B, cin, js.shape[1])
    for L in (4 * stride, 2 * stride, 6 * stride):
        x = rng.standard_normal((B, L, cin)).astype(np.float32)
        jy, js = j_conv_stream(jnp.asarray(x), js, jnp.asarray(w),
                               jnp.asarray(b), stride=stride,
                               dilation=dilation)
        ty, ts = conv_stream(_t(x.transpose(0, 2, 1)), ts,
                             _t(w.transpose(2, 1, 0)), _t(b), stride=stride,
                             dilation=dilation)
        np.testing.assert_allclose(ty.numpy().transpose(0, 2, 1),
                                   np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(ts.numpy().transpose(0, 2, 1),
                                   np.asarray(js), atol=0)


@pytest.mark.parametrize("cin,cout,stride,groups", [(6, 4, 2, 1),
                                                    (4, 4, 3, 4),
                                                    (8, 4, 2, 4)])
def test_convtr_stream_matches_jax(rng, cin, cout, stride, groups):
    """Plain, depthwise and two input channels a group; the weights go
    through the bridge's transposed-conv layout."""
    B, k = 2, 2 * stride
    w = rng.standard_normal((k, cin // groups, cout)).astype(np.float32) * 0.3
    b = rng.standard_normal(cout).astype(np.float32)
    mod = ConvTranspose1d(cin, cout, k, groups=groups)
    sd = from_jax_params({"w": w, "b": b}, mod)
    js = j_init_convtr(B, k, stride, cout)
    ts = init_convtr_state(B, k, stride, cout)
    for L in (3, 1, 5):
        x = rng.standard_normal((B, L, cin)).astype(np.float32)
        jy, js = j_convtr_stream(jnp.asarray(x), js, jnp.asarray(w),
                                 jnp.asarray(b), stride=stride, groups=groups)
        ty, ts = convtr_stream(_t(x.transpose(0, 2, 1)), ts, sd["w"],
                               sd["b"], stride=stride, groups=groups)
        assert tuple(ty.shape) == (B, cout, L * stride)
        np.testing.assert_allclose(ty.numpy().transpose(0, 2, 1),
                                   np.asarray(jy), atol=ATOL)
        np.testing.assert_allclose(ts.numpy().transpose(0, 2, 1),
                                   np.asarray(js), atol=ATOL)


def _stream(codec, sig, frames_per_chunk):
    """Encode then decode ``sig`` chunk by chunk → (tokens, waveform)."""
    frame = codec.frame_size
    enc = codec.init_streaming_state(sig.shape[0])
    dec = codec.init_streaming_state(sig.shape[0])
    toks, wav, pos = [], [], 0
    for m in frames_per_chunk:
        t, enc = codec.encode_chunk(sig[:, pos * frame:(pos + m) * frame], enc)
        w, dec = codec.decode_chunk(t, dec)
        toks.append(np.asarray(t))
        wav.append(np.asarray(w))
        pos += m
    return np.concatenate(toks, 1), np.concatenate(wav, 1)


def test_encodec_constant_pad_chunked_equals_batch(const_pair, rng):
    """The JAX package's constant-pad case, in the port alone."""
    _, tc = const_pair
    sig = rng.standard_normal((2, tc.frame_size * 20)).astype(np.float32)
    batch_toks = tc.sig_to_toks(sig).numpy()
    batch_sig = tc.toks_to_sig(batch_toks).numpy()
    toks, wav = _stream(tc, sig, [4] * 5)
    np.testing.assert_array_equal(toks, batch_toks)
    np.testing.assert_allclose(wav, batch_sig, atol=ATOL)


@pytest.mark.parametrize("plan", [[1, 3, 2, 6], [5, 1, 1, 5]])
def test_encodec_varying_chunk_sizes_equal_batch(const_pair, rng, plan):
    _, tc = const_pair
    sig = rng.standard_normal((1, tc.frame_size * sum(plan))).astype(
        np.float32)
    toks, wav = _stream(tc, sig, plan)
    np.testing.assert_array_equal(toks, tc.sig_to_toks(sig).numpy())
    np.testing.assert_allclose(wav, tc.toks_to_sig(toks).numpy(), atol=ATOL)


@pytest.mark.parametrize("cfg,seed", [
    (CONST, 1),
    # reflect padding in batch mode; streaming starts from zero context
    (dict(num_filters=8, hidden_size=16, upsampling_ratios=(4, 2),
          codebook_size=64, codebook_dim=16, num_quantizers=4), 0)])
def test_encodec_streaming_matches_jax_streaming(rng, cfg, seed):
    jc, tc = _pair(cfg, seed)
    frame = tc.frame_size
    sig = (rng.standard_normal((2, frame * 12)) * 0.3).astype(np.float32)
    # one chunk size: the JAX package traces each size anew
    toks, wav = _stream(tc, sig, [3] * 4)
    je, jd = jc.init_streaming_state(2), jc.init_streaming_state(2)
    jt, jw, pos = [], [], 0
    for m in [3] * 4:
        t, je = jc.encode_chunk(jnp.asarray(sig[:, pos * frame:
                                                (pos + m) * frame]), je)
        w, jd = jc.decode_chunk(t, jd)
        jt.append(np.asarray(t))
        jw.append(np.asarray(w))
        pos += m
    np.testing.assert_array_equal(toks, np.concatenate(jt, 1))
    np.testing.assert_allclose(wav, np.concatenate(jw, 1), atol=ATOL)


def test_streaming_state_is_carried_not_mutated(const_pair, rng):
    """A state can be replayed: the same chunk from the same state gives the
    same tokens, and the state passed in is left as it was."""
    _, tc = const_pair
    chunk = rng.standard_normal((1, tc.frame_size * 2)).astype(np.float32)
    s0 = tc.init_streaming_state(1)
    _, s1 = tc.encode_chunk(chunk, s0)
    before = {k: v.clone() for k, v in s1["encoder"].items()
              if isinstance(v, torch.Tensor)}
    a, _ = tc.encode_chunk(chunk, s1)
    b, _ = tc.encode_chunk(chunk, s1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in before.items():
        torch.testing.assert_close(s1["encoder"][k], v, rtol=0, atol=0)
