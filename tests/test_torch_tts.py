"""Port parity for the TTS recipe (``audiocodecs_tpu_torch/downstream/recipes/
tts.py``) against the JAX package, on the CPU.

* ``tts_nll`` with a speaker condition against the reference's ``nll``
  (local to its ``run_tts``, written out here on the JAX Llama) on the JAX
  init with a text band: within 1e-5 relative.
* ``run_tts`` end to end on the small EnCodec and the 6-utterance corpus,
  1 epoch, at ``test_recipes.py``'s widths (d 32, 1 layer, 2 heads, 1 KV
  head, 16 text tokens), generation at ``top_p`` 1e-9 (the nucleus holds
  the top token alone: ``tests/test_torch_slm.py``), the JAX init bridged
  in: char tokens with the control rows, and with the speaker prefix from
  a small WavLM x-vector (one ``.npz`` for both packages, the config of
  ``tests/test_torch_xvector.py``). ``ckpt_best.npz`` (``spk_proj``
  included) within 1e-4 of each leaf's largest, the same token cache,
  every generated grid equal, the test loss within 1e-4 relative and the
  battery as ``recipe_pairs.assert_same_summary`` holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu import codec as jcodec_mod
from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.downstream.recipes import tts as jtts
from audiocodecs_tpu_torch import codec as codec_mod
from audiocodecs_tpu_torch.downstream.models import llama
from audiocodecs_tpu_torch.downstream.models import speaker_encoder as xv
from audiocodecs_tpu_torch.downstream.recipes import tts
from audiocodecs_tpu_torch.nn.wavlm import WavLMConfig
from audiocodecs_tpu_torch.params import from_jax_params, to_jax_params
from audiocodecs_tpu_torch.utils.checkpoint import save_params
from recipe_pairs import (
    assert_same_outputs,
    assert_same_summary,
    base_cfg,
    make_inputs,
    record_codec,
    run_jax_capturing_init,
)
from test_torch_xvector import _HEAD, _TOWER
from zoo_pairs import one_thread  # noqa: F401 (autouse)

SMALL = dict(d_model=32, num_layers=1, num_heads=2, num_kv_heads=1,
             ffn_dim=64, max_text_len=16, max_flat_len=128, gen_frames=3)


def _jax_nll(params, flat, mask, cfg, spk_emb):
    """The reference's ``run_tts.nll``."""
    K, C = cfg.num_codebooks, cfg.vocab_size
    embs = jllama.llama_embed(params, flat, cfg)
    cond = jnp.einsum("bd,dh->bh", spk_emb, params["spk_proj"]["w"]) \
        + params["spk_proj"]["b"]
    embs = embs.at[:, 0].add(cond)
    logits = jllama.llama_forward(params, embs, cfg)
    L = flat.shape[1]
    cb = (jnp.arange(L - 1) % K).astype(jnp.int32)
    lg = jnp.take_along_axis(logits[:, :-1], cb[None, :, None, None],
                             axis=2)[:, :, 0]
    tgt = flat[:, 1:]
    head_tgt = jnp.where(tgt >= K * C, C + jnp.minimum(tgt - K * C, 2), tgt)
    ce = optax.softmax_cross_entropy_with_integer_labels(lg, head_tgt)
    m = mask[:, 1:]
    return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)


def test_tts_nll_with_a_speaker_matches_jax():
    kw = dict(vocab_size=17, num_codebooks=2, hidden_size=32, num_layers=2,
              num_heads=4, num_kv_heads=2, intermediate_size=64,
              num_special=3 + 9)
    cfg, jcfg = llama.LlamaConfig(**kw), jllama.LlamaConfig(**kw)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(1), jcfg))
    jp["spk_proj"] = {"w": rng.standard_normal((6, 32)).astype(np.float32),
                      "b": rng.standard_normal(32).astype(np.float32)}
    model = tts.SpeakerLlama(cfg, 6)
    model.load_state_dict(from_jax_params(jp, model), strict=True)
    B, L = 3, 20
    flat = rng.integers(0, 17, (B, L)).astype(np.int32)
    flat[:, :5] = 2 * 17 + 3 + rng.integers(0, 9, (B, 5))  # text
    flat[:, 6] = cfg.bos_token
    flat[1, 15:] = cfg.pad_token
    flat[1, 14] = cfg.eos_token
    mask = np.zeros((B, L), np.float32)
    mask[:, 7:] = 1.0
    spk = rng.standard_normal((B, 6)).astype(np.float32)
    want = float(_jax_nll(jax.tree.map(jnp.asarray, jp), jnp.asarray(flat),
                          jnp.asarray(mask), jcfg, jnp.asarray(spk)))
    with torch.no_grad():
        got = float(tts.tts_nll(model, torch.from_numpy(flat),
                                torch.from_numpy(mask), cfg,
                                torch.from_numpy(spk)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("tts_inputs")))


def _speaker_encoder(d):
    """A small WavLM x-vector's ``.npz`` and its config overrides."""
    cfg = xv.XVectorConfig(wavlm=WavLMConfig(**_TOWER), **_HEAD)
    model = xv.XVector(cfg)
    model.load_state_dict(xv.init_xvector_params(
        torch.Generator().manual_seed(0), cfg))
    path = str(d / "xv.npz")
    save_params(path, to_jax_params(model.state_dict(), model))
    over = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items() if k != "wavlm"}
    over["wavlm"] = {k: list(v) if isinstance(v, tuple) else v
                     for k, v in dataclasses.asdict(cfg.wavlm).items()}
    return path, over


@pytest.mark.parametrize("speaker", [False, True])
def test_run_tts_matches_jax(tmp_path, monkeypatch, inputs, speaker):
    extra = {"compute_ref_metrics": True}
    if speaker:
        path, over = _speaker_encoder(tmp_path)
        extra = {"speaker_encoder_checkpoint": path,
                 "speaker_encoder_config": over}
    cfg = base_cfg(inputs, tmp_path / "jax", top_p=1e-9, **SMALL, **extra)
    jseen = record_codec(monkeypatch, jcodec_mod.Codec, np.asarray)["toks"]
    want, init = run_jax_capturing_init(monkeypatch, jtts.run_tts, cfg)
    assert ("spk_proj" in init) == speaker
    seen = record_codec(monkeypatch, codec_mod.Codec,
                        lambda t: np.asarray(torch.as_tensor(t).cpu()))["toks"]
    got = tts.run_tts({**cfg, "output_folder": str(tmp_path / "port")},
                      device="cpu", init_params=init)
    monkeypatch.undo()
    assert got["generated"] > 0
    assert_same_summary(got, want)
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(seen) == len(jseen) > 0
    for a, b in zip(seen, jseen):
        assert np.array_equal(a, b)
