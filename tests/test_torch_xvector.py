"""The WavLM x-vector and speaker similarity of the port
(``audiocodecs_tpu_torch/downstream/models/speaker_encoder.py``, the SpkSim
factory of ``downstream/metrics/external.py``) against the JAX package, on
the CPU, at a small config (a 2-layer, 16-wide WavLM tower, TDNN 8-8-12).

* Embeddings (weighted layer sum and last layer) within 1e-5 relative of
  the JAX package's, on the port's seeded weights carried across.
* The converter: leaf for leaf equal to the JAX converter's on a
  ``synth_state_dict`` draw of HF ``WavLMForXVector``'s keys.
* SpkSim from one ``.npz`` (the reference's format) within 1e-5 of the JAX
  metric's; the HF-directory path gives the same scores.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.metrics import external as jexternal
from audiocodecs_tpu.downstream.models import speaker_encoder as jxv
from audiocodecs_tpu.nn.wavlm import WavLMConfig as JWavLMConfig
from audiocodecs_tpu.utils.checkpoint import save_params
from audiocodecs_tpu_torch.convert.torch_utils import synth_state_dict
from audiocodecs_tpu_torch.downstream.metrics import external
from audiocodecs_tpu_torch.downstream.models import speaker_encoder as xv
from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from metric_pairs import speech
from zoo_pairs import one_thread  # noqa: F401 (autouse)

REL = 1e-5
_TOWER = dict(hidden_size=16, num_layers=2, num_heads=2,
              intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 4),
              conv_stride=(5, 2), num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, num_buckets=32,
              max_distance=64)
_HEAD = dict(tdnn_dim=(8, 8, 12), tdnn_kernel=(3, 3, 1),
             tdnn_dilation=(1, 2, 1), xvector_dim=6)


def _config(weighted=True):
    return (xv.XVectorConfig(wavlm=WavLMConfig(**_TOWER), **_HEAD,
                             use_weighted_layer_sum=weighted),
            jxv.XVectorConfig(wavlm=JWavLMConfig(**_TOWER), **_HEAD,
                              use_weighted_layer_sum=weighted))


def _pair(weighted=True):
    cfg, jcfg = _config(weighted)
    model = xv.XVector(cfg)
    model.load_state_dict(xv.init_xvector_params(
        torch.Generator().manual_seed(0), cfg))
    tree = to_jax_params(model.state_dict(), model)
    return model, jax.tree.map(jnp.asarray, tree), jcfg, tree


@torch.no_grad()
@pytest.mark.parametrize("weighted", [True, False])
def test_embeddings_match_jax(weighted):
    model, jparams, jcfg, _ = _pair(weighted)
    wav = (np.random.default_rng(0).standard_normal((2, 3200))
           * 0.1).astype(np.float32)
    got = xv.apply_xvector(model, torch.from_numpy(wav)).numpy()
    want = np.asarray(jxv.apply_xvector(jparams, jnp.asarray(wav), jcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_converter_matches_jax_leaf_for_leaf():
    cfg, jcfg = _config()
    model = xv.XVector(cfg)
    sd = synth_state_dict(xv.xvector_schema(cfg), seed=3)
    got = xv.convert_xvector_state_dict(sd, cfg)
    want = from_jax_params(jxv.convert_xvector_state_dict(sd, jcfg), model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_spksim_from_one_npz_matches_jax(tmp_path):
    model, _, _, tree = _pair()
    path = str(tmp_path / "xvector.npz")
    save_params(path, tree)
    config = {"wavlm": dict(_TOWER),
              **{k: list(v) if isinstance(v, tuple) else v
                 for k, v in _HEAD.items()}}
    port = external.make_speaker_similarity_metric(
        checkpoint=path, config=json.loads(json.dumps(config)),
        device="cpu")
    ref = jexternal.make_speaker_similarity_metric(checkpoint=path,
                                                   config=config)
    refs = [speech(1.0, 0), speech(0.6, 1)]
    hyps = [r + 0.05 * np.random.default_rng(i).standard_normal(
        r.size).astype(np.float32) for i, r in enumerate(refs)]
    got = port.metric(hyps, refs, 16000)
    np.testing.assert_allclose(got, ref.metric(hyps, refs, 16000),
                               rtol=0, atol=REL)
    np.testing.assert_allclose(port.metric(refs, refs, 16000), 1.0,
                               atol=1e-6)
    _, cfg, embed = xv.load_xvector(path, config, device="cpu")
    assert cfg == dataclasses.replace(model.cfg)
    assert embed(refs[0][None]).shape == (1, 6)

    # an HF WavLMForXVector directory (config.json + pytorch_model.bin)
    hf = tmp_path / "hf"
    hf.mkdir()
    sd = synth_state_dict(xv.xvector_schema(model.cfg), seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               hf / "pytorch_model.bin")
    (hf / "config.json").write_text(json.dumps({
        "hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 32, "conv_dim": [8, 8], "conv_kernel": [10, 4],
        "conv_stride": [5, 2], "conv_bias": False,
        "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
        "layer_norm_eps": 1e-5, "do_stable_layer_norm": False,
        "feat_extract_norm": "group", "num_buckets": 32,
        "max_bucket_distance": 64, "tdnn_dim": [8, 8, 12],
        "tdnn_kernel": [3, 3, 1], "tdnn_dilation": [1, 2, 1],
        "xvector_output_dim": 6, "use_weighted_layer_sum": True}))
    from_dir = external.make_speaker_similarity_metric(str(hf),
                                                       device="cpu")
    m2 = xv.XVector(model.cfg)
    m2.load_state_dict(xv.convert_xvector_state_dict(sd, model.cfg))
    save_params(str(tmp_path / "b.npz"), to_jax_params(m2.state_dict(), m2))
    same = external.make_speaker_similarity_metric(
        checkpoint=str(tmp_path / "b.npz"), config=config, device="cpu")
    np.testing.assert_allclose(from_dir.metric(hyps, refs, 16000),
                               same.metric(hyps, refs, 16000), atol=1e-7)
