"""Port parity: the zoo's transformer codecs of ``audiocodecs_tpu_torch``
(StableCodec, MagiCodec) against the JAX package's on the same weights
(carried across by ``from_jax_params``) and the same numpy inputs, on the
CPU.

Small configs (``tests/test_codec_zoo2.py``'s) with every leaf redrawn:
tokens identical, features, qfeats and waveforms within 1e-4 of their
largest magnitude, the bridge back, the modes, the embeddings and the
balanced tier, and the decoder at fp32 activations and one bf16 pass
against the reference's under ``ACX_DEC_CONV_PRECISION=default``. Then
their published widths (dim 1024, 16 heads, FFN 4096,
MagiCodec's 131,072 × 16 codebook) with the depth cut to 2 blocks a tower,
on B = 1 x 0.5 s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiocodecs_tpu.models.magicodec import MagiCodec as JMagiCodec
from audiocodecs_tpu.models.magicodec import MagiCodecModelConfig as JMConfig
from audiocodecs_tpu.models.stablecodec import StableCodec as JStableCodec
from audiocodecs_tpu_torch.models.magicodec import (
    MagiCodec,
    MagiCodecModelConfig,
    init_magicodec_params,
)
from audiocodecs_tpu_torch.models.stablecodec import (
    StableCodec,
    StableCodecModelConfig,
    init_stablecodec_params,
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

STABLE_SMALL = dataclasses.replace(
    JStableCodec.default_model_config(bottleneck=(4, 729)), patch=8, dim=16,
    depth_outer=1, depth_inner=1, num_heads=2)
MAGI_SMALL = JMConfig(sampling_rate=16000, hop_length=8, dim=16, depth=2,
                      num_heads=2, codebook_size=64, codebook_dim=8)

FAMILIES = {
    # name: (JAX class, port class, port config, small config, K, port init)
    "stablecodec": (JStableCodec, StableCodec, StableCodecModelConfig,
                    STABLE_SMALL, 2, init_stablecodec_params),
    "magicodec": (JMagiCodec, MagiCodec, MagiCodecModelConfig, MAGI_SMALL, 1,
                  init_magicodec_params),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def small(request):
    jcls, tcls, tcfg, jcfg, K, _ = FAMILIES[request.param]
    return (request.param, *pair(jcls, tcls, tcfg, jcfg, 16000,
                                 num_codebooks=K))


def _sig(rng, B, T):
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


def test_small_tokens_identical_features_close(small, rng):
    """Two rows of a ragged length (StableCodec pads to whole windows;
    MagiCodec's patch conv floors); then the weight bridge back, the
    modes, the embeddings and the balanced tier. MagiCodec's features are
    its 8-d latents, which its decoder does not take (it decodes the
    ``out_proj`` image), so its decode of features is not asked."""
    name, jc, tc = small
    magi = name == "magicodec"
    want = check_roundtrip(jc, tc, _sig(rng, 2, 331), feats_decode=not magi)
    assert want["toks"].shape[1] == (41 if magi else 21)
    check_bridge(jc, tc)
    check_modes(type(jc), type(tc), tc, (jc.model_config, jc.params), 16000,
                num_codebooks=tc.config.num_codebooks)
    close(tc.embs(), np.asarray(jc.embs()))
    if magi:
        lat = MagiCodec(16000, latent=True, model_config=tc.model_config,
                        device="cpu", state_dict=tc.state_dict())
        assert lat.embs().shape == (1, 64, 8)
        close(tc.feats_to_sig(want["qfeats"]),
              jc.feats_to_sig(want["qfeats"]))
    check_tier(jc, tc, name, want["toks"])


def test_small_one_pass_decode(small, rng):
    """The decoder's RoFormer products and transposed conv in one bf16
    pass, as the reference's ``conv_role("decoder")`` under
    ``ACX_DEC_CONV_PRECISION=default``."""
    _, jc, tc = small
    check_one_pass_decode(jc, tc, tc.sig_to_toks(_sig(rng, 2, 331)).numpy())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_init_is_seeded_and_complete(name):
    _, tcls, tcfg_cls, jcfg, K, init = FAMILIES[name]
    cfg = tcfg_cls(**dataclasses.asdict(jcfg))
    a = init(torch.Generator().manual_seed(3), cfg)
    b = init(torch.Generator().manual_seed(3), cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tc = tcls(16000, model_config=cfg, num_codebooks=K, device="cpu",
              state_dict=a)
    assert sorted(tc.state_dict()) == sorted(a)


def test_stablecodec_bottlenecks():
    for bottleneck, (K, C) in {(1, 46656): (1, 46656), (2, 15625): (2, 15625),
                               (4, 729): (4, 729)}.items():
        cfg = StableCodec.default_model_config(bottleneck=bottleneck)
        assert cfg == StableCodecModelConfig(**dataclasses.asdict(
            JStableCodec.default_model_config(bottleneck=bottleneck)))
        assert (len(cfg.scales), cfg.vocab_size) == (K, C)
    with pytest.raises(ValueError, match="bottleneck"):
        StableCodec.default_model_config(bottleneck=(1, 1000))


@pytest.mark.parametrize("name,cut", [
    ("stablecodec", dict(depth_outer=2, depth_inner=2)),
    ("magicodec", dict(depth=2))])
def test_published_width_depth_cut(rng, name, cut):
    """dim 1024, 16 heads, FFN 4096 (and MagiCodec's 131,072-row codebook),
    2 blocks a tower."""
    jcls, tcls, tcfg_cls, _, _, _ = FAMILIES[name]
    jcfg = dataclasses.replace(jcls.default_model_config(), **cut)
    jc, tc = pair(jcls, tcls, tcfg_cls, jcfg, 16000, seed=None)
    want = check_roundtrip(jc, tc, _sig(rng, 1, 8000),
                           feats_decode=name != "magicodec")
    assert want["toks"].shape[1] == (13 if name == "stablecodec" else 25)
