"""Port parity: ``audiocodecs_tpu_torch`` X-Codec 2.0 against the JAX
package's on the same weights (carried across by ``from_jax_params``) and
the same numpy inputs, on the CPU.

Small config (``tests/test_codec_zoo4.py``'s: ngf 4, 16-d branches, a
2-layer w2v-BERT tapped at 2, a 2-block RoFormer) with every leaf redrawn:
tokens identical, features, qfeats and waveforms within 1e-4 of their
largest magnitude, the decode of features without re-quantizing, the
65,536 × 8 lattice, the modes, the balanced tier and the decoder at fp32
activations and one bf16 pass (its embed conv and RoFormer products)
against the reference's under ``ACX_DEC_CONV_PRECISION=default``. Then the published
widths (BigCodec's encoder at ngf 48 with its H = 1536 LSTM, w2v-BERT at
1024 wide, 16 heads, FFN 4096; the RoFormer at 1024) with the depth cut to
2 conformer layers (tapped at 2) and 2 RoFormer blocks, on B = 1 x 0.5 s.
"""

import numpy as np
import pytest
import torch

from audiocodecs_tpu.models.xcodec2 import XCodec2 as JXCodec2
from audiocodecs_tpu.models.xcodec2 import XCodec2ModelConfig as JConfig
from audiocodecs_tpu.nn.w2vbert import W2VBertConfig as JW2VConfig
from audiocodecs_tpu_torch.models.xcodec2 import (
    XCodec2,
    XCodec2ModelConfig,
    init_xcodec2_params,
)
from zoo_pairs import (
    check_bridge,
    check_modes,
    check_one_pass_decode,
    check_roundtrip,
    check_tier,
    one_thread,  # noqa: F401 (autouse)
    pair,
    port_config,
)

SMALL = JConfig(
    ngf=4, acoustic_dim=16, semantic_dim=16, fused_dim=32,
    w2vbert=JW2VConfig(hidden_size=16, num_layers=2, num_heads=2,
                       intermediate_size=32, conv_kernel=5),
    semantic_layer=2, backbone_depth=2, backbone_heads=2)


@pytest.fixture(scope="module")
def small():
    return pair(JXCodec2, XCodec2, XCodec2ModelConfig, SMALL, 16000)


def _sig(rng, B, T):
    return (rng.standard_normal((B, T)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("B,T,N", [(2, 1600, 5), (1, 2111, 6)])
def test_small_tokens_identical_features_close(small, rng, B, T, N):
    """Both branches' frames: the acoustic encoder's convs floor, w2v-BERT's
    10 ms frames of the padded waveform are stacked in pairs; the fewer
    win."""
    jc, tc = small
    want = check_roundtrip(jc, tc, _sig(rng, B, T))
    assert want["toks"].shape == (B, N, 1)
    assert want["sig"].shape == (B, N * 320)
    assert int(want["toks"].max()) < 65536


def test_small_bridge_modes_embs_and_tier(small, rng):
    jc, tc = small
    check_bridge(jc, tc)
    check_modes(JXCodec2, XCodec2, tc, (jc.model_config, jc.params), 16000)
    emb = tc.embs()
    assert emb.shape == (1, 65536, 8)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jc.embs()))
    toks = np.asarray(jc.sig_to_toks(_sig(rng, 2, 1600)))
    check_tier(jc, tc, "xcodec2", toks)
    check_one_pass_decode(jc, tc, toks)
    with pytest.raises(ValueError, match="single-codebook"):
        XCodec2(16000, num_codebooks=2, device="cpu")


def test_init_is_seeded_and_complete():
    cfg = port_config(XCodec2ModelConfig, SMALL)
    a = init_xcodec2_params(torch.Generator().manual_seed(3), cfg)
    b = init_xcodec2_params(torch.Generator().manual_seed(3), cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    tc = XCodec2(16000, model_config=cfg, device="cpu", state_dict=a)
    assert sorted(tc.state_dict()) == sorted(a)
    # the reference's tree has the encoder's snake α as [1, 1, C]
    assert tc.encoder.alpha_out.ndim == 1


def test_published_width_depth_cut(rng):
    """dim 1024 everywhere, 16 heads, FFN 4096, the acoustic LSTM at
    H = 1536; depth cut to 2 conformer layers and 2 RoFormer blocks."""
    jcfg = JConfig(w2vbert=JW2VConfig(num_layers=2), semantic_layer=2,
                   backbone_depth=2)
    jc, tc = pair(JXCodec2, XCodec2, XCodec2ModelConfig, jcfg, 16000,
                  seed=None)
    assert tc.encoder.rnn[0].w_hh.shape == (1536, 4 * 1536)
    want = check_roundtrip(jc, tc, _sig(rng, 1, 8000), feats_decode=False)
    assert want["toks"].shape == (1, 25, 1)
