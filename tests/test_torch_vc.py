"""Port parity for the VC recipe (``audiocodecs_tpu_torch/downstream/recipes/
vc.py``) against the JAX package, on the CPU.

* ``knn_convert`` against the reference's on numpy-seeded features:
  within 1e-5 relative; on similarities with ties at the k-th place (the
  lower index wins, as in ``jax.lax.top_k``): equal picks.
* ``splice_acoustic_tokens``: equal to the reference's.
* ``run_vc`` with each of its three strategies, 2 pairs of the 6-utterance
  corpus, on one ``checkpoint:`` npz for both packages: the small EnCodec
  of ``tests/test_recipes.py`` (``acoustic_splice``), the small BigCodec
  of ``tests/test_torch_bigcodec.py`` with ``latent: false``
  (``knn_feats``; at BigCodec's default ``latent: true`` its features are
  8-wide and its quantized features hidden-wide, and both packages raise:
  ``test_knn_feats_needs_one_feature_space``) and the small
  BiCodec of ``tests/test_torch_zoo_wavlm.py`` (``global_token_swap``),
  their weights redrawn by ``zoo_pairs.redraw``. Every token grid the
  codec makes or decodes is equal, each converted waveform within 1e-4 of
  its largest sample, the summary as ``recipe_pairs.assert_same_summary``
  holds it.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu import codec as jcodec_mod
from audiocodecs_tpu.downstream.recipes import vc as jvc
from audiocodecs_tpu.utils import audio as jaudio
from audiocodecs_tpu_torch import codec as codec_mod
from audiocodecs_tpu_torch.downstream.recipes import vc
from audiocodecs_tpu_torch.models.bicodec import BiCodec, BiCodecModelConfig
from audiocodecs_tpu_torch.models.bigcodec import (
    BigCodec,
    BigCodecModelConfig,
)
from audiocodecs_tpu_torch.params import to_jax_params
from audiocodecs_tpu_torch.utils import audio
from audiocodecs_tpu_torch.utils.checkpoint import save_params
from recipe_pairs import (
    TINY_CODEC,
    assert_same_summary,
    base_cfg,
    make_inputs,
    record_codec,
)
from zoo_pairs import one_thread, port_config, redraw  # noqa: F401
from test_torch_bigcodec import SMALL as BIG_SMALL
from test_torch_zoo_wavlm import BI_SMALL


def test_knn_convert_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((23, 8)).astype(np.float32)
    match = rng.standard_normal((31, 8)).astype(np.float32)
    want = np.asarray(jvc.knn_convert(jnp.asarray(src), jnp.asarray(match)))
    got = vc.knn_convert(torch.from_numpy(src), torch.from_numpy(match))
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())


def test_knn_convert_ties_pick_the_lower_index():
    """Match rows 1, 2, 4 and 6 are one direction at different scales, so
    a source frame along it ties among all four (cosine 1 each, exactly):
    top-2 must take rows 1 and 2, whose mean differs from every other
    pair's."""
    d = np.asarray([0.6, 0.8, 0.0], np.float32)
    match = np.stack([[0, 0, 1.0], d, 2 * d, [0, 1.0, 0], 4 * d,
                      [1.0, 0, 0], 8 * d]).astype(np.float32)
    src = np.stack([d * 3, [0, 0, 1.0], [1.0, 0.1, 0]]).astype(np.float32)
    sims = (src / np.linalg.norm(src, axis=1, keepdims=True)) @ (
        match / np.linalg.norm(match, axis=1, keepdims=True)).T
    assert len(set(np.round(sims[0, [1, 2, 4, 6]], 7))) == 1
    want = np.asarray(jvc.knn_convert(jnp.asarray(src), jnp.asarray(match),
                                      topk=2))
    got = vc.knn_convert(torch.from_numpy(src), torch.from_numpy(match),
                         topk=2).numpy()
    np.testing.assert_allclose(want[0], 1.5 * d, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_splice_matches_jax():
    rng = np.random.default_rng(1)
    src, ref = rng.integers(0, 32, (17, 4)), rng.integers(0, 32, (5, 4))
    assert np.array_equal(vc.splice_acoustic_tokens(src, ref),
                          jvc.splice_acoustic_tokens(src, ref))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("vc_inputs")))


def _codec_block(name, d, inputs):
    """The ``codec:`` block of each strategy's case: EnCodec from
    ``make_inputs``, or BigCodec's or BiCodec's small config with the
    port's init redrawn into one checkpoint."""
    if name == "encodec":
        return {**TINY_CODEC, "checkpoint": inputs[0]}
    if name == "bigcodec":
        mc = BigCodecModelConfig(**BIG_SMALL)
        tc = BigCodec(16000, 16000, model_config=mc, device="cpu",
                      generator=torch.Generator().manual_seed(0))
        over = dataclasses.asdict(mc)
    else:
        mc = port_config(BiCodecModelConfig, BI_SMALL)
        tc = BiCodec(16000, 16000, model_config=mc, device="cpu",
                     generator=torch.Generator().manual_seed(0))
        over = dataclasses.asdict(BI_SMALL)
    tree = jax.tree.map(np.asarray, redraw(to_jax_params(tc.state_dict(), tc),
                                           7))
    ckpt = os.path.join(d, f"{name}.npz")
    save_params(ckpt, tree)
    block = {"name": name, "orig_sample_rate": 16000, "num_codebooks": 1,
             "model_overrides": over, "checkpoint": ckpt}
    if name == "bigcodec":
        # kNN-VC needs the features and the quantized features in one
        # space: BigCodec's encoder side (hidden), not its latent one
        block["kwargs"] = {"latent": False}
    return block


@pytest.mark.parametrize("name,strategy", [
    ("encodec", "acoustic_splice"), ("bigcodec", "knn_feats"),
    ("bicodec", "global_token_swap")])
def test_run_vc_matches_jax(tmp_path, monkeypatch, inputs, name, strategy):
    cfg = base_cfg(inputs, tmp_path / "jax", max_pairs=2,
                   codec=_codec_block(name, str(tmp_path), inputs))
    jseen = record_codec(monkeypatch, jcodec_mod.Codec, np.asarray,
                         encodes=True, audio_mod=jaudio)
    # (the JAX build_codec writes its model_config into the block's kwargs)
    want = jvc.run_vc(copy.deepcopy(cfg))
    monkeypatch.undo()
    seen = record_codec(monkeypatch, codec_mod.Codec,
                        lambda t: np.asarray(torch.as_tensor(t).cpu()),
                        encodes=True, audio_mod=audio)
    got = vc.run_vc({**cfg, "output_folder": str(tmp_path / "port")},
                    device="cpu")
    monkeypatch.undo()
    assert got["strategy"] == want["strategy"] == strategy
    assert got["pairs"] == 2
    assert len(seen["toks"]) == len(jseen["toks"]) > 0
    for a, b in zip(seen["toks"], jseen["toks"]):
        assert np.array_equal(a, b)
    assert [n for n, _ in seen["wavs"]] == [n for n, _ in jseen["wavs"]]
    for (_, a), (_, b) in zip(seen["wavs"], jseen["wavs"]):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
    assert_same_summary(got, want)


def test_knn_feats_needs_one_feature_space(tmp_path, inputs):
    cfg = base_cfg(inputs, tmp_path / "port", max_pairs=1,
                   codec=_codec_block("bigcodec", str(tmp_path), inputs))
    del cfg["codec"]["kwargs"]
    with pytest.raises(ValueError, match="latent"):
        vc.run_vc(cfg, device="cpu")
    with pytest.raises(TypeError):
        jvc.run_vc({**cfg, "output_folder": str(tmp_path / "jax")})
