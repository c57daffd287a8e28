"""Port parity: ``audiocodecs_tpu_torch.nn.wavlm`` against the JAX package's
``nn/wavlm.py`` on the same weights (carried across by ``to_jax_params``,
every leaf redrawn from numpy) and the same numpy waveform, on the CPU.

The bucket table equals the reference's, as integers, for every length up
to 1,500 frames. The tower's three configurations (WavLM-base: post-norm
with the GroupNorm extractor; WavLM-large: pre-norm with a LayerNorm after
each conv; wav2vec2-XLSR: WavLM-large's shape with plain attention), at a
small width with the reference's structure (an even positional kernel in
groups, distances past the exact buckets), agree within 1e-4 of the
largest magnitude in every output mode: the final states, an interior
``output_layer``, ``output_hidden_states``, and a full-depth tap with and
without ``final_ln_tap``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from audiocodecs_tpu.nn import wavlm as jwavlm
from audiocodecs_tpu_torch.nn.wavlm import (
    WavLM,
    WavLMConfig,
    apply_wavlm,
    init_wavlm_params,
    rel_pos_buckets,
)
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from zoo_pairs import close, one_thread, redraw  # noqa: F401 (autouse)

_SMALL = dict(hidden_size=32, num_layers=3, num_heads=4,
              intermediate_size=64, conv_dim=(16, 16, 16),
              conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
              num_buckets=32, max_distance=64)
CONFIGS = {
    "base": WavLMConfig(**_SMALL),
    "large": WavLMConfig(**_SMALL, conv_bias=True, do_stable_layer_norm=True,
                         feat_extract_norm="layer"),
    "xlsr": WavLMConfig(**_SMALL, conv_bias=True, do_stable_layer_norm=True,
                        feat_extract_norm="layer", gated_rel_pos=False),
}
MODES = {
    "final": {},
    "interior_layer": {"output_layer": 2},
    "hidden_states": {"output_hidden_states": True},
    "full_depth_tap": {"output_layer": 3},
    "full_depth_tap_unnormed": {"output_layer": 3, "final_ln_tap": False},
    "hidden_states_unnormed": {"output_hidden_states": True,
                               "final_ln_tap": False},
}


def test_bucket_table_equals_the_reference():
    """A bucket depends on the distance only, so the 1,500-frame table
    holds every distance of a shorter one; the short ones are checked too
    (the exact buckets, the first log buckets)."""
    for T in (*range(1, 40), 127, 128, 499, 500, 801, 1000, 1499, 1500):
        got = rel_pos_buckets(T, T, 320, 800)
        want = jwavlm._rel_pos_buckets(T, T, 320, 800)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=str(T))
    np.testing.assert_array_equal(rel_pos_buckets(7, 300, 32, 64),
                                  jwavlm._rel_pos_buckets(7, 300, 32, 64))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def tower(request):
    """The port's tower at a configuration, its weights redrawn, a numpy
    waveform, and the reference's output of it in every mode (one
    compile)."""
    cfg = CONFIGS[request.param]
    model = WavLM(cfg)
    model.load_state_dict(init_wavlm_params(torch.Generator().manual_seed(0),
                                            cfg), strict=True)
    tree = redraw(to_jax_params(model.state_dict(), model), 1)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, tree),
                                          model), strict=True)
    jcfg = jwavlm.WavLMConfig(**dataclasses.asdict(cfg))
    sig = (np.random.default_rng(0).standard_normal((2, 4003))
           * 0.5).astype(np.float32)
    want = jax.jit(lambda p, x: {
        mode: jwavlm.apply_wavlm(p, x, jcfg, **kw)
        for mode, kw in MODES.items()})(tree, sig)
    return request.param, model, sig, jax.tree.map(np.asarray, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_hidden_states_match_the_reference(tower, mode):
    name, model, sig, want = tower
    kw = MODES[mode]
    want = want[mode]
    with torch.no_grad():
        got = apply_wavlm(model, torch.from_numpy(sig), model.cfg, **kw)
    close(got, want)
    if mode == "hidden_states":
        assert got.shape[0] == model.cfg.num_layers + 1
    if name != "base" and mode == "full_depth_tap_unnormed":
        # the final LayerNorm moves a full-depth tap in the pre-norm tower
        with torch.no_grad():
            normed = apply_wavlm(model, torch.from_numpy(sig), model.cfg,
                                 output_layer=3)
        assert not torch.allclose(normed, got)


def test_init_is_seeded_and_complete():
    for cfg in CONFIGS.values():
        a = init_wavlm_params(torch.Generator().manual_seed(3), cfg)
        b = init_wavlm_params(torch.Generator().manual_seed(3), cfg)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert sorted(WavLM(cfg).state_dict()) == sorted(a)
