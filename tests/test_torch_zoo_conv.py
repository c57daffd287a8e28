"""Port parity: the zoo's conv codecs of ``audiocodecs_tpu_torch`` (AudioDec,
HILCodec with its streaming encoder, NanoCodec) against the JAX package's
on the same weights (carried across by ``from_jax_params``) and the same
numpy inputs, on the CPU.

Small configs (``tests/test_codec_zoo2.py``'s and ``tests/test_streaming.
py``'s) with every leaf redrawn (``zoo_pairs.redraw``): tokens identical,
features, qfeats and waveforms within 1e-4 of their largest magnitude.
HILCodec's ``encode_chunk`` in 1-, 2- and 3-frame chunks gives its batch
tokens and JAX's chunks' tokens. Each family once at its published width on
B = 1 x 0.5 s, its weights as drawn. The balanced serving tier
decodes as the exact one, in both packages. HILCodec's decoder at fp32
activations and one bf16 pass follows the reference's under
``ACX_DEC_CONV_PRECISION=default``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiocodecs_tpu.models.audiodec import AudioDec as JAudioDec
from audiocodecs_tpu.models.audiodec import AudioDecModelConfig as JADConfig
from audiocodecs_tpu.models.hilcodec import HILCodec as JHILCodec
from audiocodecs_tpu.models.hilcodec import HILCodecModelConfig as JHILConfig
from audiocodecs_tpu.models.nanocodec import NanoCodec as JNanoCodec
from audiocodecs_tpu.models.nanocodec import NanoCodecModelConfig as JNConfig
from audiocodecs_tpu_torch.models.audiodec import (
    AudioDec,
    AudioDecModelConfig,
    init_audiodec_params,
)
from audiocodecs_tpu_torch.models.hilcodec import (
    HILCodec,
    HILCodecModelConfig,
    init_hilcodec_params,
)
from audiocodecs_tpu_torch.models.nanocodec import (
    NanoCodec,
    NanoCodecModelConfig,
    init_nanocodec_params,
    half_snake,
)
from zoo_pairs import (
    check_bridge,
    check_modes,
    check_one_pass_decode,
    check_roundtrip,
    check_tier,
    close,
    one_thread,  # noqa: F401 (autouse)
    pair,
)

AD_SMALL = dict(sampling_rate=1200, encode_channels=4, channel_ratios=(2, 4),
                strides=(3, 4), code_dim=8, codebook_size=32,
                num_quantizers=4)
HIL_SMALL = dict(sampling_rate=800, channels=4, max_channels=16,
                 strides=(4, 2), emb_dim=8, codebook_size=32,
                 num_quantizers=4)
NANO_SMALL = dict(sampling_rate=800, base_channels=4,
                  down_sample_rates=(4, 2), resblock_kernels=(3, 5),
                  resblock_dilations=(1, 3), levels=(5, 5, 5), num_groups=4)

FAMILIES = {
    # name: (JAX class, port class, port config, small config, rate, K,
    #        port init)
    "audiodec": (JAudioDec, AudioDec, AudioDecModelConfig,
                 JADConfig(**AD_SMALL), 1200, 2, init_audiodec_params),
    "hilcodec": (JHILCodec, HILCodec, HILCodecModelConfig,
                 JHILConfig(**HIL_SMALL), 800, 3, init_hilcodec_params),
    "nanocodec": (JNanoCodec, NanoCodec, NanoCodecModelConfig,
                  JNConfig(**NANO_SMALL), 800, 4, init_nanocodec_params),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def small(request):
    jcls, tcls, tcfg, jcfg, sr, K, _ = FAMILIES[request.param]
    return (request.param, *pair(jcls, tcls, tcfg, jcfg, sr,
                                 num_codebooks=K))


def _sig(rng, B, T):
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


def test_small_tokens_identical_features_close(small, rng):
    """Two rows of a ragged length (each family's framing: AudioDec and
    NanoCodec round the frame count up, HILCodec down); then the weight
    bridge back, the modes, and the balanced tier."""
    name, jc, tc = small
    want = check_roundtrip(jc, tc, _sig(rng, 2, 331))
    np.testing.assert_array_equal(tc.embs().numpy(), np.asarray(jc.embs()))
    check_bridge(jc, tc)
    check_modes(type(jc), type(tc), tc, (jc.model_config, jc.params),
                tc.sample_rate, num_codebooks=tc.config.num_codebooks)
    check_tier(jc, tc, name, want["toks"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_is_seeded_and_complete(name):
    _, tcls, tcfg_cls, jcfg, sr, K, init = FAMILIES[name]
    cfg = tcfg_cls(**dataclasses.asdict(jcfg))
    a = init(torch.Generator().manual_seed(3), cfg)
    b = init(torch.Generator().manual_seed(3), cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tc = tcls(sr, sr, model_config=cfg, num_codebooks=K, device="cpu",
              state_dict=a)
    want = {k: (v[:K] if name == "audiodec" and k == "codebooks" else v)
            for k, v in a.items()}
    assert sorted(tc.state_dict()) == sorted(want)
    with pytest.raises(ValueError, match="num_codebooks"):
        tcls(sr, sr, model_config=cfg, num_codebooks=9, device="cpu")


def test_half_snake_matches_the_reference(rng):
    from audiocodecs_tpu.models.nanocodec import _half_snake

    x = rng.standard_normal((2, 50, 6)).astype(np.float32)
    alpha = (np.abs(rng.standard_normal(3)) + 0.1).astype(np.float32)
    alpha[0] = 0.0  # the 1e-9 floor
    want = np.asarray(_half_snake(x, alpha))
    got = half_snake(torch.from_numpy(x).transpose(1, 2),
                     torch.from_numpy(alpha)).transpose(1, 2)
    close(got, want, 1e-6)


def test_hilcodec_one_pass_decode(rng):
    """Every decoder conv of HILCodec in one bf16 pass, as the reference's
    ``conv_role("decoder")`` under ``ACX_DEC_CONV_PRECISION=default``."""
    jcls, tcls, tcfg, jcfg, sr, K, _ = FAMILIES["hilcodec"]
    jc, tc = pair(jcls, tcls, tcfg, jcfg, sr, num_codebooks=K)
    check_one_pass_decode(jc, tc, tc.sig_to_toks(_sig(rng, 2, 331)).numpy())


@pytest.fixture(scope="module")
def hil_stream():
    """``tests/test_streaming.py``'s streaming HILCodec (24 kHz, strides
    (4, 2)), its weights redrawn."""
    jcfg = JHILConfig(**{**HIL_SMALL, "sampling_rate": 24000})
    return pair(JHILCodec, HILCodec, HILCodecModelConfig, jcfg, 24000,
                seed=4, num_codebooks=3)


@pytest.mark.parametrize("plan", [(1,) * 12, (2,) * 6, (3,) * 4,
                                  (1, 3, 2, 6)], ids=str)
def test_hilcodec_encode_chunk_equals_batch_and_jax(hil_stream, rng, plan):
    """Chunks of whole frames carry each causal conv's left context: the
    tokens are the batch encoder's, and JAX's chunks' tokens."""
    jc, tc = hil_stream
    frame = tc.frame_size
    sig = _sig(rng, 2, frame * 12)
    want = tc.sig_to_toks(sig).numpy()
    np.testing.assert_array_equal(want, np.asarray(jc.sig_to_toks(sig)))
    state, jstate = tc.init_streaming_state(2), jc.init_streaming_state(2)
    assert sorted(state) == sorted(jstate)
    for k, v in jstate.items():
        assert tuple(state[k].shape) == (v.shape[0], v.shape[2], v.shape[1])
    got, jgot, pos = [], [], 0
    for m in plan:
        chunk = sig[:, pos * frame:(pos + m) * frame]
        t, state = tc.encode_chunk(chunk, state)
        jt, jstate = jc.encode_chunk(chunk, jstate)
        got.append(t.numpy())
        jgot.append(np.asarray(jt))
        pos += m
    np.testing.assert_array_equal(np.concatenate(got, 1), want)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(jgot, 1))
    for k, v in jstate.items():
        close(state[k].transpose(1, 2), v)


@pytest.mark.parametrize("name,T", [("audiodec", 12000), ("hilcodec", 12000),
                                    ("nanocodec", 8820)])
def test_published_width(rng, name, T):
    """The published config with the port's init (the reference's
    distributions), one JAX call each (B = 1, 0.5 s): tokens identical,
    features and the decode within 1e-4."""
    jcls, tcls, tcfg_cls, _, _, _, _ = FAMILIES[name]
    jcfg = jcls.default_model_config()
    sr = jcfg.sampling_rate
    jc, tc = pair(jcls, tcls, tcfg_cls, jcfg, sr, seed=None)
    check_roundtrip(jc, tc, _sig(rng, 1, T), feats_decode=False)
