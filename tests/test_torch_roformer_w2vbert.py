"""Port parity: ``audiocodecs_tpu_torch.nn.roformer``, ``nn.kaldi_fbank`` and
``nn.w2vbert`` against the JAX package's on the same numpy inputs and
weights (carried across by ``from_jax_params``), on the CPU.

RoFormer in both forms the zoo uses (gated attention with a GELU FFN, as
X-Codec 2.0 and MagiCodec; gateless with SwiGLU, as StableCodec), with
RoPE on part of each head; its phases bit for bit. The kaldi fbank with
both windows it is called with (povey, 80 bins: w2v-BERT; Hann, 128 bins:
AudioMAE and SemantiCodec), its mel banks bit for bit (the log where the
band holds energy; near-empty bands are held in energy). w2v-BERT's front
end and its conformer at an ``output_layer`` below ``num_layers``, on more
frames than the relative positions reach (offsets clamped to [−64, 8]).
All within 1e-4 of the reference's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.nn import kaldi_fbank as JK
from audiocodecs_tpu.nn import roformer as JR
from audiocodecs_tpu.nn import w2vbert as JW
from audiocodecs_tpu_torch.nn import kaldi_fbank as TK
from audiocodecs_tpu_torch.nn import roformer as TR
from audiocodecs_tpu_torch.nn import w2vbert as TW
from audiocodecs_tpu_torch.params import from_jax_params
from zoo_pairs import close, one_thread, redraw  # noqa: F401 (autouse)

ROFORMERS = {
    "gated_gelu": JR.RoformerConfig(dim=32, depth=2, num_heads=2, rope_dim=8),
    "swiglu": JR.RoformerConfig(dim=32, depth=2, num_heads=2, rope_dim=16,
                                use_gates=False, ffn="swiglu"),
}


@pytest.mark.parametrize("name", sorted(ROFORMERS))
@torch.no_grad()
def test_roformer_matches_the_reference(rng, name):
    jcfg = ROFORMERS[name]
    params = redraw(JR.init_roformer_params(jax.random.PRNGKey(0), jcfg), 1)
    cfg = TR.RoformerConfig(**dataclasses.asdict(jcfg))
    model = TR.Roformer(cfg)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          model), strict=True)
    sd = TR.init_roformer_params(torch.Generator().manual_seed(0), cfg)
    assert sorted(sd) == sorted(model.state_dict())
    x = rng.standard_normal((2, 37, 32)).astype(np.float32)
    want = np.asarray(JR.apply_roformer(params, jnp.asarray(x), jcfg))
    close(model(torch.from_numpy(x)), want)


def test_rope_phases_bit_for_bit():
    cfg = JR.RoformerConfig()
    jc, js = JR._rope_phases(500, cfg)
    tc, ts = TR._rope_phases(500, TR.RoformerConfig(), "cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("window,bins", [("povey", 80), ("hanning", 128)])
def test_kaldi_fbank_matches_the_reference(rng, window, bins):
    sig = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    want = np.asarray(JK.kaldi_fbank(sig, 16000, bins, window=window))
    got = TK.kaldi_fbank(torch.from_numpy(sig), 16000, bins, window=window)
    assert got.shape == want.shape == (2, 29, bins)
    # the mel energies within 1e-4 of the largest; the log where the energy
    # is above 1e-6 of it: Hann's lowest bin at 128 bins holds ~1e-14 of
    # the largest (its filter sits on the DC-removed, preemphasised bins),
    # where the two FFTs' fp32 rounding is a relative 1e-3
    close(torch.exp(got.double()), np.exp(want.astype(np.float64)))
    big = want > np.log(np.exp(want).max()) + np.log(1e-6)
    close(got.numpy()[big], want[big])
    np.testing.assert_array_equal(TK._banks(16000, 512, bins),
                                  JK._banks(16000, 512, bins))
    close(TK.audiomae_normalize(torch.from_numpy(want)),
          JK.audiomae_normalize(want), 1e-7)
    empty = TK.kaldi_fbank(torch.zeros(1, 300), 16000, bins, window=window)
    assert empty.shape == (1, 0, bins)
    with pytest.raises(ValueError, match="window"):
        TK.kaldi_fbank(torch.zeros(1, 800), window="hamming")


@pytest.mark.parametrize("T", [4000, 4160])  # 23 and 24 fbank frames
def test_w2vbert_features_match_the_reference(rng, T):
    sig = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    want = np.asarray(JW.w2vbert_features(jnp.asarray(sig)))
    got = TW.w2vbert_features(torch.from_numpy(sig))
    assert got.shape == want.shape == (2, 12, 160)
    close(got, want)


@torch.no_grad()
def test_w2vbert_stops_at_the_tapped_layer(rng):
    """Three conformer layers, tapped at 2 (and at 0, the projection), over
    90 frames: past both clamps of the relative positions."""
    jcfg = JW.W2VBertConfig(hidden_size=32, num_layers=3, num_heads=2,
                            intermediate_size=64, conv_kernel=5)
    params = redraw(JW.init_w2vbert_params(jax.random.PRNGKey(0), jcfg), 2)
    cfg = TW.W2VBertConfig(**dataclasses.asdict(jcfg))
    model = TW.W2VBert(cfg)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          model), strict=True)
    assert model.layers[0].conv.dw.shape == (32, 1, 5)
    sd = TW.init_w2vbert_params(torch.Generator().manual_seed(0), cfg)
    assert sorted(sd) == sorted(model.state_dict())
    feats = rng.standard_normal((2, 90, 160)).astype(np.float32)
    f = torch.from_numpy(feats)
    for layer in (2, 0, None):
        want = np.asarray(JW.apply_w2vbert(params, feats, jcfg,
                                           output_layer=layer))
        close(TW.apply_w2vbert(model, f, cfg, output_layer=layer), want)
    # the layers past the tap are not run: 3 states, not 4
    states = TW.apply_w2vbert(model, f, cfg, output_layer=2,
                              output_hidden_states=True)
    want = np.asarray(JW.apply_w2vbert(params, feats, jcfg, output_layer=2,
                                       output_hidden_states=True))
    assert states.shape[0] == 3
    close(states, want)
