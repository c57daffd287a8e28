"""Port parity for the Conformer encoder (``audiocodecs_tpu_torch/nn/
conformer.py``) against the JAX package, on the CPU, on the JAX init with
every leaf redrawn from numpy (``zoo_pairs.redraw``: biases and norm gains
move the output too) and carried across by ``conformer_from_jax``.

* The forward within 1e-5 relative to the largest output, at k = 31 with
  an odd T above the kernel and one below it (the zero pad is wider than
  the sequence), and at an even kernel (the pad's split is asymmetric).
* The gradient of a weighted sum of the outputs, through the trainer's
  ``compute_loss``, for every leaf within 1e-4 of that leaf's largest.
* ``init_conformer_params`` has the JAX tree's keys and shapes; the
  bridge goes both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.nn import conformer as jconformer
from audiocodecs_tpu_torch.downstream.recipes.trainer import Trainer
from audiocodecs_tpu_torch.nn import conformer
from audiocodecs_tpu_torch.params import flatten_tree, to_jax_params
from zoo_pairs import one_thread, redraw  # noqa: F401 (autouse)

KW = dict(hidden_size=32, num_layers=2, num_heads=4)


def _pair(conv_kernel=31, seed=0):
    jcfg = jconformer.ConformerConfig(conv_kernel=conv_kernel, **KW)
    cfg = conformer.ConformerConfig(conv_kernel=conv_kernel, **KW)
    tree = redraw(jconformer.init_conformer_params(jax.random.PRNGKey(seed),
                                                   jcfg), seed)
    tree = jax.tree.map(np.asarray, tree)
    return conformer.conformer_from_jax(tree, cfg, "cpu"), tree, cfg, jcfg


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("conv_kernel,T", [(31, 37), (31, 13), (6, 21)])
def test_forward_matches_jax(conv_kernel, T):
    model, tree, cfg, jcfg = _pair(conv_kernel)
    x = np.random.default_rng(T).standard_normal((2, T, 32)).astype(
        np.float32)
    want = jconformer.apply_conformer(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = conformer.apply_conformer(model, torch.from_numpy(x), cfg)
    assert got.shape == (2, T, 32)
    assert _rel(got, want) <= 1e-5
    assert torch.equal(model(torch.from_numpy(x)).detach(), got)


def test_gradients_through_the_trainer_match_jax(tmp_path):
    model, tree, cfg, jcfg = _pair(31, seed=1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    r = rng.standard_normal((2, 19, 32)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jconformer.apply_conformer(p, jnp.asarray(x), jcfg)
                       * jnp.asarray(r))

    jgrads = flatten_tree(jax.tree.map(np.asarray, jax.grad(jloss)(
        jax.tree.map(jnp.asarray, tree))))

    def loss_fn(m, batch, generator):
        y = conformer.apply_conformer(m, batch["x"], cfg)
        return torch.sum(y * batch["r"]), {}

    trainer = Trainer(loss_fn, model, output_folder=str(tmp_path))
    loss, _ = trainer.compute_loss({"x": torch.from_numpy(x),
                                    "r": torch.from_numpy(r)}, None)
    value = float(loss.detach())
    want = float(jloss(jax.tree.map(jnp.asarray, tree)))
    assert abs(value - want) <= 1e-5 * abs(want)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    got = flatten_tree(to_jax_params(dict(zip(names, grads)), model))
    assert sorted(got) == sorted(jgrads)
    for k, want in jgrads.items():
        err = float(np.abs(got[k] - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (k, err)


def test_init_has_the_reference_tree_and_bridges_back():
    cfg = conformer.ConformerConfig(**KW)
    jcfg = jconformer.ConformerConfig(**KW)
    sd = conformer.init_conformer_params(torch.Generator().manual_seed(0),
                                         cfg)
    model = conformer.Conformer(cfg)
    model.load_state_dict(sd, strict=True)
    got = flatten_tree(to_jax_params(sd, model))
    want = flatten_tree(jax.tree.map(np.asarray, jconformer.
                                     init_conformer_params(
                                         jax.random.PRNGKey(0), jcfg)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    back = conformer.conformer_from_jax(to_jax_params(sd, model), cfg, "cpu")
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the reference's distributions: the depthwise taps at 0.05, zero biases
    w = sd["layers.0.conv.dw.w"]
    assert w.shape == (32, 1, 31) and 0.03 < float(w.std()) < 0.07
    assert float(sd["layers.1.q.b"].abs().max()) == 0.0
