"""Port parity for the SLM recipe (``audiocodecs_tpu_torch/downstream/recipes/
slm.py``) and the task dispatcher (``downstream/recipes/__main__.py``)
against the JAX package, on the CPU.

* ``flatten_with_specials``: equal to the reference's.
* ``next_token_nll`` against the reference's ``nll`` (local to its
  ``run_slm``, written out here on the JAX Llama) on the JAX init, with
  padded rows and a zero-mask prefix: within 1e-5 relative.
* Both packages' nucleus filters keep exactly the top token at a
  ``top_p`` of 1e-9, so a draw from it is the argmax whatever the
  generator.
* ``run_slm`` end to end on the small EnCodec and the 6-utterance corpus,
  1 epoch, at ``test_recipes.py``'s widths (d 32, 1 layer, 2 heads, 1 KV
  head), generation at ``top_p`` 1e-9 and the control rows on, the JAX
  init bridged in: ``ckpt_best.npz`` within 1e-4 of each leaf's largest,
  the same token cache, every generated grid equal, the PPL within 1e-4
  relative, ``consistency_ER`` and the battery as ``recipe_pairs.
  assert_same_summary`` holds them.
* What the recipe refuses, as the reference does: two parallel degrees
  above 1, ``expert_parallel`` without experts, and a model axis larger
  than the launched ranks (checked before anything is built). The
  parallel runs themselves are ``tests/test_torch_parallel_recipes.py``.
* The dispatcher: the JAX one's 11 tasks, help and an unknown task, and
  ``vc`` run through it with ``--device cpu`` from one YAML.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu import codec as jcodec_mod
from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.downstream.recipes import __main__ as jdispatch
from audiocodecs_tpu.downstream.recipes import slm as jslm
from audiocodecs_tpu_torch import codec as codec_mod
from audiocodecs_tpu_torch.downstream.models import llama
from audiocodecs_tpu_torch.downstream.recipes import __main__ as dispatch
from audiocodecs_tpu_torch.downstream.recipes import slm
from recipe_pairs import (
    assert_same_outputs,
    assert_same_summary,
    base_cfg,
    make_inputs,
    record_codec,
    run_jax_capturing_init,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)

SMALL = dict(d_model=32, num_layers=1, num_heads=2, num_kv_heads=1,
             ffn_dim=64, max_flat_len=128, gen_frames=3)
KW = dict(vocab_size=17, num_codebooks=2, hidden_size=32, num_layers=2,
          num_heads=4, num_kv_heads=2, intermediate_size=64, max_seq_len=64)


def test_flatten_with_specials_matches_jax():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 17, (3, 9, 2))
    length = np.asarray([1.0, 0.5, 0.0], np.float32)
    for max_flat in (24, 12):
        got = slm.flatten_with_specials(toks, length, 34, 35, 36, max_flat)
        want = jslm.flatten_with_specials(toks, length, 34, 35, 36, max_flat)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def _jax_nll(params, flat, mask, cfg):
    """The reference's ``run_slm.nll`` without the MoE term."""
    K, C = cfg.num_codebooks, cfg.vocab_size
    logits = jllama.llama_forward(params, jllama.llama_embed(params, flat,
                                                             cfg), cfg)
    L = flat.shape[1]
    cb = (jnp.arange(L - 1) % K).astype(jnp.int32)
    lg = jnp.take_along_axis(logits[:, :-1], cb[None, :, None, None],
                             axis=2)[:, :, 0]
    tgt = flat[:, 1:]
    head_tgt = jnp.where(tgt >= K * C, C + (tgt - K * C), tgt)
    ce = optax.softmax_cross_entropy_with_integer_labels(lg, head_tgt)
    m = mask[:, 1:]
    return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)


def test_next_token_nll_matches_jax():
    cfg, jcfg = llama.LlamaConfig(**KW), jllama.LlamaConfig(**KW)
    jp = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jcfg))
    model = llama.llama_from_jax(jp, cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 17, (3, 10, 2))
    flat, mask = jslm.flatten_with_specials(
        toks, np.asarray([1.0, 0.6, 0.3], np.float32), cfg.bos_token,
        cfg.eos_token, cfg.pad_token, 26)
    mask[0, :7] = 0.0  # a prompt whose targets do not count
    want = float(_jax_nll(jax.tree.map(jnp.asarray, jp), jnp.asarray(flat),
                          jnp.asarray(mask), jcfg))
    with torch.no_grad():
        got = float(slm.next_token_nll(model, torch.from_numpy(flat),
                                       torch.from_numpy(mask), cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_nucleus_at_tiny_top_p_keeps_only_the_top_token():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((64, 40)) * 3).astype(np.float32)
    got = llama.nucleus_filter(torch.from_numpy(logits), 1e-9).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    draws = np.stack([np.asarray(jllama._sample_top_p(
        k, jnp.asarray(logits), 1e-9)) for k in keys])
    top = logits.argmax(-1)
    assert (np.isfinite(got).sum(-1) == 1).all()
    assert np.array_equal(np.isfinite(got).argmax(-1), top)
    assert (draws == top[None]).all()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("slm_inputs")))


def test_run_slm_matches_jax(tmp_path, monkeypatch, inputs):
    cfg = base_cfg(inputs, tmp_path / "jax", top_p=1e-9,
                   compute_ref_metrics=True, **SMALL)
    jseen = record_codec(monkeypatch, jcodec_mod.Codec, np.asarray)["toks"]
    want, init = run_jax_capturing_init(monkeypatch, jslm.run_slm, cfg)
    seen = record_codec(monkeypatch, codec_mod.Codec,
                        lambda t: np.asarray(torch.as_tensor(t).cpu()))["toks"]
    got = slm.run_slm({**cfg, "output_folder": str(tmp_path / "port")},
                      device="cpu", init_params=init)
    monkeypatch.undo()
    assert got["generated"] > 0 and "consistency_ER" in got
    assert_same_summary(got, want)
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the generated grids (and the control rows' decodes of the cache)
    assert len(seen) == len(jseen) > 0
    for a, b in zip(seen, jseen):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cfg,match", [
    ({"model_parallel": 2, "pipeline_parallel": 2}, "set ONE of"),
    ({"pipeline_parallel": 2, "expert_parallel": 2, "moe_experts": 4},
     "set ONE of"),
    ({"expert_parallel": 2}, "expert_parallel needs moe_experts > 0"),
    ({"model_parallel": 2}, "needs a multiple of that many ranks")])
def test_parallel_and_moe_raise(cfg, match):
    with pytest.raises(ValueError, match=match):
        slm.run_slm(cfg, device="cpu")


def test_dispatcher_tasks_help_and_unknown(capsys):
    assert dispatch._RECIPES.keys() == jdispatch._RECIPES.keys()
    for task, (module, fn) in dispatch._RECIPES.items():
        assert module.startswith("audiocodecs_tpu_torch.downstream.recipes.")
        assert module.replace("_torch", "", 1) == jdispatch._RECIPES[task][0]
        assert fn == "main"
    assert dispatch.main(["--help"]) == 0
    assert dispatch.main(["nope"]) == 2
    assert dispatch.main([]) == 2
    assert "available tasks: asr, ic, ks, se, ser, si, slm, sr, ss, tts, vc" \
        in capsys.readouterr().out


def test_dispatcher_runs_a_task_on_the_cpu(tmp_path, inputs, capsys):
    cfg = base_cfg(inputs, tmp_path / "vc", max_pairs=1)
    path = tmp_path / "vc.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert dispatch.main(["vc", str(path), "--device", "cpu"]) == 0
    with open(tmp_path / "vc" / "summary.json") as f:
        summary = json.load(f)
    assert summary["pairs"] == 1
    assert json.loads(capsys.readouterr().out) == summary
