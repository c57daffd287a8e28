"""Port parity for the SS recipe (``audiocodecs_tpu_torch/downstream/recipes/
ss.py``) against the JAX package, on the CPU.

* ``ss_forward`` on the JAX init (S·K heads; uniform vocab and a
  per-codebook tuple repeated per speaker): within 1e-5 relative.
* ``pit_loss`` against the reference's PIT written in JAX with optax (its
  ``loss_fn`` is local to ``run_ss``), S = 2 and 3 over ragged lengths:
  within 1e-6 relative, and its gradient with respect to the logits within
  1e-5 of the largest.
* ``run_ss`` end to end on the small EnCodec and the 6-utterance corpus, 1
  epoch, at ``test_recipes.py``'s widths, the JAX init bridged in:
  ``ckpt_best.npz`` within 1e-4 of each leaf's largest; the PIT loss
  within 1e-4 relative, the best-permutation SI-SNR and the battery's
  means within ``recipe_pairs.SUMMARY_TOL``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.downstream.recipes import ss as jss
from audiocodecs_tpu.nn.transformer import TransformerConfig as JTConfig
from audiocodecs_tpu.nn.transformer import init_transformer_params as jt_init
from audiocodecs_tpu.utils.masking import length_mask as jlength_mask
from audiocodecs_tpu_torch.downstream.recipes import se, ss
from recipe_pairs import (
    assert_same_outputs,
    assert_same_summary,
    base_cfg,
    make_inputs,
    run_jax_capturing_init,
)
from zoo_pairs import one_thread, redraw  # noqa: F401 (autouse)

SMALL = dict(d_model=32, num_layers=1, num_heads=2, ffn_dim=64)


@pytest.mark.parametrize("C", [32, (32, 20)])
def test_ss_forward_matches_jax(C):
    K, S, H = 2, 2, 32
    jcfg = JTConfig(hidden_size=H, num_layers=1, num_heads=2, num_kv_heads=2,
                    head_dim=16, intermediate_size=64, act="gelu",
                    norm="layernorm", causal=False)
    rows = sum(C) if isinstance(C, tuple) else K * C
    tree = jax.tree.map(np.asarray, redraw({
        "embedding": {"table": jnp.zeros((rows, H))},
        "pool": {"logits": jnp.zeros((K,))},
        "encoder": jt_init(jax.random.PRNGKey(0), jcfg),
        "head": {"w": jnp.zeros((H, S * rows)), "b": jnp.zeros((S * rows,))},
    }, 5))
    sizes = C if isinstance(C, tuple) else (C,) * K
    rng = np.random.default_rng(6)
    toks = np.stack([rng.integers(0, c, (3, 17)) for c in sizes], -1)
    want = np.asarray(jss.ss_forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jcfg,
        vocab_size=C, num_codebooks=K, num_speakers=S))
    model = se.token_model_from_jax(tree, K, C, se.encoder_config(SMALL),
                                    S * K, ss.head_vocab(C, S), "cpu")
    with torch.no_grad():
        got = ss.ss_forward(model, torch.from_numpy(toks), vocab_size=C,
                            num_codebooks=K, num_speakers=S).numpy()
    assert got.shape == want.shape == (3, 17, S, K, max(sizes))
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want[want > -1e8]).max())


def _jax_pit(logits, tgt, length, S, K):
    """The reference's PIT (``audiocodecs_tpu/downstream/recipes/ss.py``,
    ``run_ss.loss_fn``) on given logits."""
    perms = list(itertools.permutations(range(S)))
    mask = jlength_mask(length, logits.shape[1])[..., None]
    per_pair = []
    for s_pred in range(S):
        row = []
        for s_tgt in range(S):
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :, s_pred], tgt[:, s_tgt])
            row.append((ce * mask).sum((1, 2)) / jnp.maximum(
                mask.sum((1, 2)) * K, 1.0))
        per_pair.append(jnp.stack(row, -1))
    cost = jnp.stack(per_pair, -2)
    perm_losses = jnp.stack(
        [sum(cost[:, i, p[i]] for i in range(S)) / S for p in perms], -1)
    return perm_losses.min(-1).mean()


@pytest.mark.parametrize("S", [2, 3])
def test_pit_loss_matches_the_reference(S):
    B, N, K, C = 4, 11, 2, 13
    rng = np.random.default_rng(S)
    logits = rng.standard_normal((B, N, S, K, C)).astype(np.float32)
    tgt = rng.integers(0, C, (B, S, N, K))
    length = np.asarray([1.0, 0.55, 0.2, 0.0], np.float32)
    want, jgrad = jax.value_and_grad(_jax_pit)(
        jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(length), S, K)
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = ss.pit_loss(lg, torch.from_numpy(tgt), torch.from_numpy(length),
                      list(itertools.permutations(range(S))))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    jgrad = np.asarray(jgrad)
    assert float(np.abs(lg.grad.numpy() - jgrad).max()) <= \
        1e-5 * float(np.abs(jgrad).max())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("ss_inputs")))


def test_run_ss_matches_jax(tmp_path, monkeypatch, inputs):
    cfg = base_cfg(inputs, tmp_path / "jax", **SMALL)
    want, init = run_jax_capturing_init(monkeypatch, jss.run_ss, cfg)
    got = ss.run_ss({**cfg, "output_folder": str(tmp_path / "port")},
                    device="cpu", init_params=init)
    assert_same_summary(got, want)
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                        token_cache=False)
