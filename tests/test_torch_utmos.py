"""UTMOS and ``bilstm_masked`` of the port (``audiocodecs_tpu_torch/
downstream/metrics/utmos.py``, ``nn/lstm.py``) against the JAX package, on
the CPU, at the tiny config of ``tests/test_utmos.py`` (a 2-layer, 16-wide
wav2vec2 tower, an 8-wide BiLSTM).

* ``bilstm_masked``: its valid frames equal ``bilstm`` on the unpadded
  rows within 1e-6, and the JAX function's on the same weights within
  1e-6.
* Scores (``apply_utmos``, ``apply_utmos_padded``, ``score_from_feats``)
  and the metric from one ``.npz`` (the reference's format), bucketed and
  not: within 1e-5 relative of the JAX package's.
* The converter: both vendor layouts equal to the JAX converter's leaf for
  leaf, the hub vectors tiled, and strict.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.metrics import utmos as jutmos
from audiocodecs_tpu.nn import lstm as jlstm
from audiocodecs_tpu.nn.wavlm import WavLMConfig as JWavLMConfig
from audiocodecs_tpu.utils.checkpoint import save_params
from audiocodecs_tpu_torch.downstream.metrics import utmos
from audiocodecs_tpu_torch.nn.lstm import (
    bilstm,
    bilstm_masked,
    init_bilstm_params,
)
from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from zoo_pairs import one_thread  # noqa: F401 (autouse)

REL = 1e-5
_SSL = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            conv_dim=(8, 8), conv_kernel=(10, 4), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            gated_rel_pos=False)
_HEAD = dict(emb_dim=4, num_domains=2, num_judges=8, blstm_hidden=8,
             proj_hidden=16, judge_id=3)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    cfg = utmos.UTMOSConfig(ssl=WavLMConfig(**_SSL), **_HEAD)
    jcfg = jutmos.UTMOSConfig(ssl=JWavLMConfig(**_SSL), **_HEAD)
    model = utmos.UTMOS(cfg)
    sd = utmos.init_utmos_params(torch.Generator().manual_seed(0), cfg)
    # biases and gains that move the output
    rng = np.random.default_rng(1)
    for k, v in sd.items():
        if k.endswith(".b") or k.endswith(".g"):
            sd[k] = v + torch.from_numpy(
                0.1 * rng.standard_normal(v.shape).astype(np.float32))
    model.load_state_dict(sd)
    tree = to_jax_params(model.state_dict(), model)
    return model, cfg, jax.tree.map(jnp.asarray, tree), jcfg, tree


def _wav(n, rows=2, seed=0):
    return (np.random.default_rng(seed).standard_normal((rows, n))
            * 0.1).astype(np.float32)


@torch.no_grad()
def test_bilstm_masked_matches_unpadded_rows_and_jax():
    params = init_bilstm_params(torch.Generator().manual_seed(1), 2, 8, 6)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    lens = [5, 9, 12, 1]
    T = 12
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((n, 8)).astype(np.float32) for n in lens]
    padded = np.zeros((len(rows), T, 8), np.float32)
    for i, r in enumerate(rows):
        padded[i, : r.shape[0]] = r
    got = bilstm_masked(torch.from_numpy(padded), params,
                        torch.tensor(lens)).numpy()
    want_jax = np.asarray(jlstm.bilstm_masked(jnp.asarray(padded), jparams,
                                              jnp.asarray(lens)))
    for i, r in enumerate(rows):
        want = bilstm(torch.from_numpy(r)[None], params)[0].numpy()
        np.testing.assert_allclose(got[i, : lens[i]], want, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got[i, : lens[i]],
                                   want_jax[i, : lens[i]], rtol=0, atol=1e-6)


@torch.no_grad()
@pytest.mark.parametrize("n", [1600, 2333])
def test_apply_utmos_matches_jax(pair, n):
    model, _, jparams, jcfg, _ = pair
    wav = _wav(n)
    got = utmos.apply_utmos(model, torch.from_numpy(wav))
    want = jutmos.apply_utmos(jparams, jnp.asarray(wav), jcfg)
    _close(got, want)


@torch.no_grad()
def test_apply_utmos_padded_matches_jax_and_the_unpadded_head(pair):
    model, cfg, jparams, jcfg, _ = pair
    wav = _wav(2400, rows=3, seed=2)
    n = np.array([2400, 1700, 900])
    for i in range(1, 3):
        wav[i, n[i]:] = 0.0
    got = utmos.apply_utmos_padded(model, torch.from_numpy(wav),
                                   torch.from_numpy(n))
    want = jutmos.apply_utmos_padded(jparams, jnp.asarray(wav),
                                     jnp.asarray(n), jcfg)
    _close(got, want)
    # the full-length row scores as the unpadded call
    _close(got[:1], utmos.apply_utmos(model, torch.from_numpy(wav[:1])))
    assert utmos.conv_frames(1600, cfg) == jutmos.conv_frames(1600, jcfg)


@torch.no_grad()
def test_score_from_feats_matches_jax(pair):
    model, cfg, jparams, jcfg, _ = pair
    feats = np.random.default_rng(3).standard_normal(
        (2, 7, cfg.ssl.hidden_size)).astype(np.float32)
    _close(utmos.score_from_feats(model, torch.from_numpy(feats)),
           jutmos.score_from_feats(jparams, jnp.asarray(feats), jcfg))


@pytest.mark.parametrize("bucket", [0.0, 0.15])
def test_metric_from_one_npz_matches_jax(pair, tmp_path, bucket):
    model, cfg, _, jcfg, tree = pair
    path = str(tmp_path / "utmos.npz")
    save_params(path, tree)
    sigs = [_wav(1600, 1, 4)[0], _wav(2100, 1, 5)[0]]
    port = utmos.make_utmos_checkpoint_metric(path, cfg, bucket, "cpu")
    ref = jutmos.make_utmos_jax_metric(path, jcfg, bucket_seconds=bucket)
    _close(port.metric(sigs, 16000), ref.metric(sigs, 16000))
    # a rate other than 16 kHz is resampled first
    _close(port.metric(sigs[:1], 24000), ref.metric(sigs[:1], 24000),
           rel=1e-4)
    # a .pt state dict loads the same model
    torch.save(model.state_dict(), tmp_path / "utmos.pt")
    again = utmos.load_utmos(str(tmp_path / "utmos.pt"), cfg, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("layout", ["hub", "lightning"])
def test_converter_matches_jax_leaf_for_leaf(pair, layout):
    model, cfg, _, jcfg, _ = pair
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(s).astype(np.float32) * 0.2
          for k, s in jutmos.utmos_schema(jcfg, layout=layout).items()}
    assert utmos.utmos_schema(cfg, layout) == jutmos.utmos_schema(jcfg,
                                                                 layout)
    got = utmos.convert_utmos_state_dict(sd, cfg)
    want = from_jax_params(jutmos.convert_utmos_state_dict(sd, jcfg), model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if layout == "hub":
        np.testing.assert_array_equal(got["judge_emb"][-1].numpy(),
                                      sd["judge_emb"])
    bad = dict(sd)
    bad["mystery.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        utmos.convert_utmos_state_dict(bad, cfg)


@torch.no_grad()
def test_hub_scores_do_not_depend_on_the_ids(pair):
    model, cfg, _, _, _ = pair
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(s).astype(np.float32) * 0.2
          for k, s in utmos.utmos_schema(cfg, "hub").items()}
    m = utmos.UTMOS(cfg)
    m.load_state_dict(utmos.convert_utmos_state_dict(sd, cfg))
    other = utmos.UTMOS(dataclasses.replace(cfg, domain_id=1, judge_id=0))
    other.load_state_dict(m.state_dict())
    feats = torch.from_numpy(rng.standard_normal(
        (1, 6, cfg.ssl.hidden_size)).astype(np.float32))
    _close(utmos.score_from_feats(m, feats),
           utmos.score_from_feats(other, feats), rel=1e-6)
