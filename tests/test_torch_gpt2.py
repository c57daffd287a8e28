"""GPT-2 and ASR perplexity of the port (``audiocodecs_tpu_torch/nn/
gpt2.py``, ``convert/gpt2.py``, ``downstream/metrics/ppl.py``) against the
JAX package, on the CPU, at the toy config of ``tests/test_ppl_jax.py``
(2 layers, 32 wide) with a byte-level vocabulary and merges the test
writes (``tests/metric_pairs.py``).

* The converter: leaf for leaf equal to the JAX converter's, and strict.
* Logits within 1e-4 relative and the masked NLL within 1e-5 relative of
  the JAX package's; padding does not move the NLL.
* PPL end to end from one ``.npz`` (texts, and signals through the toy
  Whisper) within 1e-5 relative of the JAX metric's; the HF-directory
  path reads ``save_pretrained``'s files without ``transformers``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.convert import gpt2 as jconvert
from audiocodecs_tpu.downstream.metrics import external as jexternal
from audiocodecs_tpu.nn import gpt2 as jgpt2
from audiocodecs_tpu_torch.convert.gpt2 import (
    convert_gpt2_state_dict,
    gpt2_config_from_hf,
)
from audiocodecs_tpu_torch.downstream.metrics import external, ppl
from audiocodecs_tpu_torch.nn import gpt2
from audiocodecs_tpu_torch.params import from_jax_params
from metric_pairs import speech, tiny_gpt2, tiny_whisper
from zoo_pairs import one_thread  # noqa: F401 (autouse)

TEXTS = ["the cat sat on the hat", "x", "that that the", "wörld théâtre"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("gpt2")
    hf = tiny_gpt2(d)
    cfg = gpt2_config_from_hf(hf.config)
    model = gpt2.GPT2(cfg)
    model.load_state_dict(convert_gpt2_state_dict(hf.state_dict(), cfg))
    jcfg = jconvert.gpt2_config_from_hf(hf.config)
    jparams = jconvert.convert_gpt2_state_dict(hf.state_dict(), jcfg)
    return d, hf, model, jax.tree.map(jnp.asarray, jparams), jcfg, jparams


def test_converter_matches_jax_leaf_for_leaf(pair):
    _, hf, model, _, _, jparams = pair
    got = convert_gpt2_state_dict(hf.state_dict(), model.cfg)
    want = from_jax_params(jparams, model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd = dict(hf.state_dict())
    sd["transformer.h.0.bogus.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unmapped"):
        convert_gpt2_state_dict(sd, model.cfg)


@torch.no_grad()
def test_logits_and_nll_match_jax(pair):
    _, _, model, jparams, jcfg, _ = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 12))
    got = gpt2.gpt2_logits(model, torch.from_numpy(toks)).numpy()
    want = np.asarray(jgpt2.gpt2_logits(jparams, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    lens = np.array([12, 7])
    nll = gpt2.gpt2_nll(model, torch.from_numpy(toks),
                        torch.from_numpy(lens)).numpy()
    jnll = np.asarray(jgpt2.gpt2_nll(jparams, jnp.asarray(toks),
                                     jnp.asarray(lens), jcfg))
    np.testing.assert_allclose(nll, jnll, rtol=1e-5)
    padded = np.zeros((2, 16), np.int64)
    padded[:, :12] = toks
    nll_p = gpt2.gpt2_nll(model, torch.from_numpy(padded),
                          torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(nll_p, nll, rtol=1e-5)


def test_ppl_end_to_end_matches_jax(pair, tmp_path):
    d, _, model, _, _, _ = pair
    port = external.make_perplexity_metric(
        checkpoint=str(d / "gpt2.npz"), tokenizer_path=str(d),
        device="cpu")
    ref = jexternal.make_perplexity_metric(
        checkpoint=str(d / "gpt2.npz"), tokenizer_path=str(d))
    got, want = port.metric(TEXTS), ref.metric(TEXTS)
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(np.delete(got, 1), np.delete(want, 1),
                               rtol=1e-5)
    # the HF directory, read without transformers
    hf_dir = external.make_perplexity_metric(lm_path=str(d / "hf"),
                                             device="cpu")
    np.testing.assert_allclose(np.delete(hf_dir.metric(TEXTS), 1),
                               np.delete(got, 1), rtol=1e-6)
    with pytest.raises(RuntimeError, match="whisper_path"):
        hf_dir.metric([speech(0.5, 0)], 16000)
    # signals: transcribed by the toy Whisper, then scored
    w = tmp_path / "whisper"
    w.mkdir()
    tiny_whisper(w)
    port = ppl.make_perplexity_checkpoint_metric(
        str(d / "gpt2.npz"), str(d), whisper_checkpoint=str(
            w / "whisper.npz"), device="cpu")
    ref = jexternal.make_perplexity_metric(
        checkpoint=str(d / "gpt2.npz"), tokenizer_path=str(d),
        whisper_checkpoint=str(w / "whisper.npz"))
    sigs = [speech(1.0, 3)]
    np.testing.assert_allclose(port.metric(sigs, 16000),
                               ref.metric(sigs, 16000), rtol=1e-5)
