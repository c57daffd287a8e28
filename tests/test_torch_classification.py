"""Port parity for the classification recipe (``audiocodecs_tpu_torch/
downstream/recipes/classification.py``: IC, KS, SER and SI) against the JAX
package, on the CPU.

* ``probe_forward``, the cross-entropy and its gradient for every leaf, on
  the JAX init and numpy-seeded tokens: within 1e-5 relative at H = 16
  (uniform and heterogeneous vocabs), and one call at ``ic.yaml``'s
  H = 128; ``build_probe_params`` has the JAX tree's keys and shapes.
* ``run_classification`` end to end on the 6-utterance corpus with the
  small EnCodec of ``tests/test_recipes.py`` (one ``checkpoint:`` npz for
  both packages), 1 epoch, the JAX init bridged in
  (``probe_params_from_jax``): the same ``test_ER`` and best valid ER,
  ``ckpt_best.npz`` within 1e-4 relative, the same token cache; once with
  ``utt_label`` (IC) and once with ``spk_id`` (SI). Each case makes one
  JAX run.
* ``main`` with ``--device cpu`` writes its summary.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.downstream.recipes import classification as jcls
from audiocodecs_tpu_torch.downstream.recipes import classification
from recipe_pairs import (
    assert_same_outputs,
    base_cfg,
    make_inputs,
    run_jax_capturing_init,
)
from zoo_pairs import one_thread  # noqa: F401 (autouse)


def _case(H, vocab, seed=0):
    K, E, classes = 3, 12, 4
    C = vocab
    init = jax.tree.map(np.asarray, jcls.build_probe_params(
        jax.random.PRNGKey(seed), K, C, E, H, classes))
    sizes = list(C) if isinstance(C, tuple) else [C] * K
    rng = np.random.default_rng(seed)
    toks = np.stack([rng.integers(0, c, (3, 17)) for c in sizes], -1)
    length = np.asarray([1.0, 0.6, 0.25], np.float32)
    label = rng.integers(0, classes, 3)
    return init, toks, length, label, C


def _jax_loss(params, toks, length, label, C):
    logits = jcls.probe_forward(params, toks, length, vocab_size=C)
    oh = jax.nn.one_hot(label, logits.shape[-1])
    return optax.softmax_cross_entropy(logits, oh).mean(), logits


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("H,vocab", [(16, 32), (16, (32, 20, 9)),
                                     (128, 32)])
def test_probe_forward_loss_and_grads_match_jax(H, vocab):
    init, toks, length, label, C = _case(H, vocab)
    (jloss, jlogits), jgrads = jax.value_and_grad(_jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, init), jnp.asarray(toks),
        jnp.asarray(length), jnp.asarray(label), C)
    params = classification.probe_params_from_jax(init)
    for p in (params["embedding"], params["pool"], params["head"],
              *params["lstm"]):
        for t in p.values():
            t.requires_grad_(True)
    batch = {"toks": torch.from_numpy(toks),
             "length": torch.from_numpy(length),
             "label": torch.from_numpy(label)}
    logits = classification.probe_forward(params, batch["toks"],
                                          batch["length"], vocab_size=C)
    loss, aux = classification.classification_loss(params, batch, None,
                                                   vocab_size=C)
    assert _rel(logits.detach(), jlogits) <= 1e-5
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert 0.0 <= float(aux["acc"]) <= 1.0
    if H == 128:
        return
    loss.backward()
    for name in ("embedding", "pool", "head"):
        for k, g in jgrads[name].items():
            assert _rel(params[name][k].grad, g) <= 1e-5, (name, k)
    for k, g in jgrads["lstm"][0].items():
        assert _rel(params["lstm"][0][k].grad, g) <= 1e-5, ("lstm", k)


def test_build_probe_params_has_the_reference_tree():
    embs = np.random.default_rng(0).standard_normal((2, 32, 24)).astype(
        np.float32)
    got = classification.build_probe_params(
        torch.Generator().manual_seed(0), 2, 32, 16, 8, 5, codec_embs=embs)
    want = jcls.build_probe_params(jax.random.PRNGKey(0), 2, 32, 16, 8, 5,
                                   codec_embs=embs)
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), got)
    want_shapes = jax.tree.map(lambda t: tuple(t.shape), want)
    assert got_shapes == want_shapes
    assert np.array_equal(got["embedding"]["table"].numpy(),
                          np.asarray(want["embedding"]["table"]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("cls_inputs")))


@pytest.mark.parametrize("label_field", ["utt_label", "spk_id"],
                         ids=["ic", "si"])
def test_run_classification_matches_jax(tmp_path, monkeypatch, inputs,
                                        label_field):
    cfg = base_cfg(inputs, tmp_path / "jax", label_field=label_field,
                   probe_hidden=16, embedding_dim_probe=16)
    want, init = run_jax_capturing_init(monkeypatch, jcls.run_classification,
                                        cfg)
    got = classification.run_classification(
        {**cfg, "output_folder": str(tmp_path / "port")}, device="cpu",
        init_params=init)
    assert got["num_classes"] == want["num_classes"]
    assert got["test_ER"] == want["test_ER"]
    assert got["best_valid_ER"] == want["best_valid_ER"]
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_main_runs_on_the_cpu(tmp_path, inputs, capsys):
    import yaml

    cfg = base_cfg(inputs, tmp_path / "main", probe_hidden=16,
                   embedding_dim_probe=16)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert classification.main([str(path), "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "main" / "summary.json").read_text())
    assert 0.0 <= summary["test_ER"] <= 1.0
    assert (tmp_path / "main" / "ckpt_latest.npz").exists()
