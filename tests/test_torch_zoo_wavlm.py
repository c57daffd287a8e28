"""Port parity: the zoo's WavLM-tower codecs of ``audiocodecs_tpu_torch``
(WavLM + K-means, DyCAST, FocalCodec, BiCodec) against the JAX package's on
the same weights (carried across by ``from_jax_params``) and the same numpy
inputs, on the CPU.

Small configs (``tests/test_codec_zoo3.py``'s and ``test_codec_zoo4.py``'s
tiny towers, each family's frames on the tower's 20-sample grid) with every
leaf redrawn (``zoo_pairs.redraw``): tokens identical, features, qfeats and
waveforms within 1e-4 of their largest magnitude, the bridge back, the
modes and the embeddings. DyCAST's small config fills its segment capacity
and clips a duration, and runs once with the retriever on. The balanced
tier: WavLM + K-means and DyCAST decode their SEANet vocoders in bf16, held
to the reference's tier as the SEANet families' are; FocalCodec and
BiCodec decode as their exact tier. Each family once at its published
widths with the tower cut to 2 layers, on B = 1 x 0.5 s: ``token_match``
≥ 0.99, features and the decode of the reference's tokens within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiocodecs_tpu.models.bicodec import BiCodec as JBiCodec
from audiocodecs_tpu.models.bicodec import BiCodecModelConfig as JBConfig
from audiocodecs_tpu.models.dycast import DyCAST as JDyCAST
from audiocodecs_tpu.models.dycast import DyCASTModelConfig as JDConfig
from audiocodecs_tpu.models.focalcodec import FocalCodec as JFocalCodec
from audiocodecs_tpu.models.focalcodec import FocalCodecModelConfig as JFConfig
from audiocodecs_tpu.models.wavlm_kmeans import WavLMKmeans as JWavLMKmeans
from audiocodecs_tpu.models.wavlm_kmeans import (
    WavLMKmeansModelConfig as JWKConfig,
)
from audiocodecs_tpu.nn.wavlm import WavLMConfig as JWavLMConfig
from audiocodecs_tpu_torch.models.bicodec import (
    BiCodec,
    BiCodecModelConfig,
    init_bicodec_params,
)
from audiocodecs_tpu_torch.models.dycast import (
    DyCAST,
    DyCASTModelConfig,
    init_dycast_params,
)
from audiocodecs_tpu_torch.models.focalcodec import (
    FocalCodec,
    FocalCodecModelConfig,
    init_focalcodec_params,
)
from audiocodecs_tpu_torch.models.wavlm_kmeans import (
    WavLMKmeans,
    WavLMKmeansModelConfig,
    init_wavlm_kmeans_params,
)
from seanet_tier import check_family_tier
from zoo_pairs import (
    check_bridge,
    check_modes,
    check_one_pass_decode,
    check_roundtrip,
    check_tier,
    close,
    jax_outputs,
    one_thread,  # noqa: F401 (autouse)
    pair,
    port_config,
)

TINY = JWavLMConfig(
    hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_distance=50)
TINY_LARGE = dataclasses.replace(TINY, do_stable_layer_norm=True,
                                 feat_extract_norm="layer", conv_bias=True)
TINY_XLSR = dataclasses.replace(TINY_LARGE, gated_rel_pos=False)

WK_SMALL = JWKConfig(layer_ids=(1, 3), num_clusters=16, wavlm=TINY_LARGE,
                     vocoder_filters=4, vocoder_ratios=(5, 2, 2))
DY_SMALL = JDConfig(num_channels=8, max_segments=8, max_duration=8,
                    wavlm=TINY, wavlm_layer=2, vocoder_filters=4,
                    vocoder_ratios=(5, 2, 2))
FOCAL_SMALL = JFConfig(codebook_bits=6, wavlm=TINY_LARGE, wavlm_layer=3,
                       compressor_blocks=2, vocos_dim=8,
                       vocos_intermediate_dim=16, vocos_layers=2, n_fft=80,
                       hop_length=20)
BI_SMALL = JBConfig(
    w2v=TINY_XLSR, feat_layers=(1, 2), encoder_dim=8,
    encoder_intermediate_dim=16, encoder_layers=2, latent_dim=16,
    codebook_size=64, codebook_dim=8, num_mels=20, n_fft=64, win_length=40,
    hop_length=20, speaker_channels=16, speaker_dim=16, perceiver_dim=8,
    perceiver_depth=1, fsq_levels=(4, 4, 4), prenet_dim=8,
    prenet_intermediate_dim=16, prenet_layers=2, decoder_channels=16,
    decoder_rates=(4, 5), decoder_kernels=(8, 10))

FAMILIES = {
    # name: (JAX class, port class, port config, small config, K, port init)
    "wavlm_kmeans": (JWavLMKmeans, WavLMKmeans, WavLMKmeansModelConfig,
                     WK_SMALL, 2, init_wavlm_kmeans_params),
    "dycast": (JDyCAST, DyCAST, DyCASTModelConfig, DY_SMALL, 9,
               init_dycast_params),
    "focalcodec": (JFocalCodec, FocalCodec, FocalCodecModelConfig,
                   FOCAL_SMALL, 1, init_focalcodec_params),
    "bicodec": (JBiCodec, BiCodec, BiCodecModelConfig, BI_SMALL, 1,
                init_bicodec_params),
}
# the families whose vocoder reads the activation dtype (a bf16 tier)
BF16_TIER = ("wavlm_kmeans", "dycast")


def _sig(rng, B, T):
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def small(request):
    jcls, tcls, tcfg, jcfg, K, _ = FAMILIES[request.param]
    return (request.param, *pair(jcls, tcls, tcfg, jcfg, 16000,
                                 num_codebooks=K))


def test_small_tokens_identical_features_close(small, rng):
    """Two rows of a ragged length; then the weight bridge back, the
    modes and the embeddings."""
    name, jc, tc = small
    want = check_roundtrip(jc, tc, _sig(rng, 2, 811))
    check_bridge(jc, tc)
    K = tc.config.num_codebooks
    check_modes(type(jc), type(tc), tc, (jc.model_config, jc.params), 16000,
                num_codebooks=K)
    close(tc.embs(), np.asarray(jc.embs()))
    if name == "dycast":  # S segments of 8 channels and the duration
        assert want["toks"].shape == (2, 8, 9)
        assert want["sig"].shape == (2, 8 * 4 * 20)
    elif name == "bicodec":  # 32 global tokens, then the frames
        assert want["toks"].shape == (2, 32 + 40, 1)
        assert int(want["toks"][:, :32].max()) < 64
    else:
        assert want["toks"].shape == (2, 40, K)


def test_small_tiers(small, rng):
    """The balanced tier against the reference's; fp32 activations at one
    bf16 pass against the reference's ``ACX_DEC_CONV_PRECISION=default``
    where its vocoder reads the decoder's precision, and exact where it
    opens no decoder scope."""
    name, jc, tc = small
    sig = _sig(rng, 2, 800)
    K = tc.config.num_codebooks
    toks = tc.sig_to_toks(sig).numpy()
    if name in BF16_TIER:
        check_family_tier(
            name, jc, tc,
            lambda: type(jc)(16000, 16000, model_config=jc.model_config,
                             params=jc.params, num_codebooks=K),
            lambda **kw: type(tc)(16000, 16000, model_config=tc.model_config,
                                  device="cpu", state_dict=tc.state_dict(),
                                  num_codebooks=K, **kw),
            sig)
        check_one_pass_decode(jc, tc, toks)
    else:
        check_tier(jc, tc, name, toks)
        one = type(tc)(16000, 16000, model_config=tc.model_config,
                       device="cpu", state_dict=tc.state_dict(),
                       decode_precision="default")
        assert torch.equal(one.toks_to_sig(toks), tc.toks_to_sig(toks))


def test_dycast_fills_its_capacity_and_clips_durations(rng):
    """About half the frames start a segment on these weights, so 40
    frames fill the 8 segments: every frame past the 7th segment pools
    into it, whose duration is clipped to 7 (``max_duration`` − 1); the
    decode is S · 4 · 20 samples whatever the input. Random grids whose
    durations overrun the 32-frame budget decode as the reference's."""
    jcls, tcls, tcfg, jcfg, K, _ = FAMILIES["dycast"]
    jc, tc = pair(jcls, tcls, tcfg, jcfg, 16000, num_codebooks=K)
    sig = _sig(rng, 2, 800)
    with torch.inference_mode():
        _, counts, num_segments = tc._segments(torch.from_numpy(sig))
    assert num_segments.tolist() == [8, 8]
    assert int(counts[:, -1].min()) > 7
    toks = check_roundtrip(jc, tc, sig)["toks"]
    assert (toks[:, -1, -1] == 7).all()
    assert tc.toks_to_sig(toks[:1]).shape == (1, 640)
    grid = np.concatenate([rng.integers(0, 4, (3, 8, 8)),
                           rng.integers(2, 8, (3, 8, 1))], axis=-1)
    assert (grid[..., -1].sum(-1) > 32).any()
    close(tc.toks_to_sig(grid), np.asarray(jc.toks_to_sig(grid)))


def test_dycast_retriever(rng):
    """The kNN retriever on (a 16-entry bank, threshold 0.3 so that some
    segment features are replaced and some kept in the decode of features;
    the decode of tokens sees the level-2 lattice, whose points are all 0
    here: on these weights no FSQ latent falls below −3.8, so every bit is
    1)."""
    jcls, tcls, tcfg, _, K, _ = FAMILIES["dycast"]
    jcfg = dataclasses.replace(DY_SMALL, use_retriever=True,
                               retriever_bank_size=16, sim_threshold=0.3)
    jc, tc = pair(jcls, tcls, tcfg, jcfg, 16000, num_codebooks=K)
    sig = _sig(rng, 2, 800)
    check_roundtrip(jc, tc, sig)
    with torch.inference_mode():
        feats = tc.sig_to_feats(sig)
        kept = (tc._retrieve(feats) == feats).all(-1)
    assert 0 < int(kept.sum()) < kept.numel()
    check_modes(jcls, tcls, tc, (jcfg, jc.params), 16000, num_codebooks=K)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_is_seeded_and_complete(name):
    _, tcls, tcfg_cls, jcfg, K, init = FAMILIES[name]
    cfg = port_config(tcfg_cls, jcfg)
    a = init(torch.Generator().manual_seed(3), cfg)
    b = init(torch.Generator().manual_seed(3), cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tc = tcls(16000, model_config=cfg, num_codebooks=K, device="cpu",
              state_dict=a)
    assert sorted(tc.state_dict()) == sorted(a)


def test_wavlm_kmeans_hifigan_vocoder(rng):
    """``vocoder_variant="hifigan"`` (512 channels, rates (10, 8, 2, 2),
    hop 320) on the small tower: tokens identical, the decodes within 1e-4,
    the bridge and the modes; its balanced tier decodes exactly, in the
    reference as in the port (``check_tier``), and so does one bf16 pass at
    fp32 activations."""
    jcls, tcls, tcfg, _, K, init = FAMILIES["wavlm_kmeans"]
    jcfg = dataclasses.replace(WK_SMALL, vocoder_variant="hifigan")
    jc, tc = pair(jcls, tcls, tcfg, jcfg, 16000, num_codebooks=K)
    sig = _sig(rng, 2, 811)
    want = check_roundtrip(jc, tc, sig)
    assert want["sig"].shape == (2, 40 * 320)
    check_bridge(jc, tc)
    check_modes(jcls, tcls, tc, (jcfg, jc.params), 16000, num_codebooks=K)
    check_tier(jc, tc, "wavlm_kmeans", want["toks"])
    one = tcls(16000, 16000, model_config=tc.model_config, device="cpu",
               state_dict=tc.state_dict(), num_codebooks=K,
               decode_precision="default")
    assert torch.equal(one.toks_to_sig(want["toks"]),
                       tc.toks_to_sig(want["toks"]))
    cfg = port_config(tcfg, jcfg)
    a = init(torch.Generator().manual_seed(3), cfg)
    assert sorted(tcls(16000, model_config=cfg, num_codebooks=K,
                       device="cpu", state_dict=a).state_dict()) == sorted(a)


def _cut(name):
    """The published widths with the tower cut to 2 layers (and the taps
    moved onto them)."""
    jcls = FAMILIES[name][0]
    mc = jcls.default_model_config()
    if name == "bicodec":  # and its two 12-block ConvNeXt stacks to 2
        return dataclasses.replace(
            mc, w2v=dataclasses.replace(mc.w2v, num_layers=2),
            feat_layers=(1, 2), encoder_layers=2, prenet_layers=2)
    cut = {"wavlm": dataclasses.replace(mc.wavlm, num_layers=2)}
    if name == "wavlm_kmeans":
        cut["layer_ids"] = (2,)
    else:
        cut["wavlm_layer"] = 2
    return dataclasses.replace(mc, **cut)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_published_width_depth_cut(rng, name):
    """WavLM-large (WavLM-base for DyCAST, wav2vec2-XLSR for BiCodec) at
    1024 (768) wide, 16 (12) heads, FFN 4096 (3072), with the published
    vocoders, quantizers and heads; 2 layers of the tower (and of
    BiCodec's ConvNeXt encoder and prenet)."""
    jcls, tcls, tcfg_cls, _, _, _ = FAMILIES[name]
    K = 33 if name == "dycast" else 1
    jc, tc = pair(jcls, tcls, tcfg_cls, _cut(name), 16000, seed=None,
                  num_codebooks=K)
    sig = _sig(rng, 1, 8000)
    want = jax_outputs(jc, sig, feats_decode=False)
    toks = tc.sig_to_toks(sig).numpy()
    assert toks.shape == want["toks"].shape
    assert (toks == want["toks"]).mean() >= 0.99
    close(tc.sig_to_feats(sig), want["feats"])
    close(tc.toks_to_sig(want["toks"]), want["sig"])
