"""Port parity for the SE recipe (``audiocodecs_tpu_torch/downstream/recipes/
se.py``) against the JAX package, on the CPU.

* ``se_forward`` on the JAX init (numpy-seeded tokens, both encoder types,
  uniform and heterogeneous vocabs): within 1e-5 relative; ``init_token_
  model`` has the JAX tree's keys and shapes.
* ``run_se`` end to end on the small EnCodec of ``tests/test_recipes.py``
  and the 6-utterance corpus, 1 epoch, at ``test_recipes.py``'s widths
  (d 32, 1 layer, 2 heads), the JAX init bridged in: with the transformer
  and the control rows, and with the Conformer at k = 31.
  ``ckpt_best.npz`` within 1e-4 of each leaf's largest (the Conformer's
  key biases within 1e-3: ``KEY_BIAS``), no token cache;
  the summary's TER within 1e-4 relative and the battery's means within
  ``recipe_pairs.SUMMARY_TOL``. Each case makes one JAX run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.recipes import se as jse
from audiocodecs_tpu.nn.conformer import ConformerConfig as JConformerConfig
from audiocodecs_tpu.nn.conformer import init_conformer_params as jconf_init
from audiocodecs_tpu.nn.transformer import TransformerConfig as JTConfig
from audiocodecs_tpu.nn.transformer import init_transformer_params as jt_init
from audiocodecs_tpu_torch.downstream.recipes import se
from audiocodecs_tpu_torch.params import flatten_tree, to_jax_params
from recipe_pairs import (
    assert_same_outputs,
    assert_same_summary,
    base_cfg,
    make_inputs,
    run_jax_capturing_init,
)
from zoo_pairs import one_thread, redraw  # noqa: F401 (autouse)

SMALL = dict(d_model=32, num_layers=1, num_heads=2, ffn_dim=64)

# The Conformer's attention key bias has a gradient near zero by
# construction: a bias added to every key shifts each query's scores by one
# constant, which the softmax cancels, and under RoPE only its
# fast-rotating parts reach the loss. Adam divides each element's step by
# that element's own gradient scale, so last-bit differences of those
# near-zero gradients become step differences: 4.6e-4 of the leaf's
# largest after the run's two steps at k = 31 (every other leaf within
# 3e-6). Its gradient itself is held to 1e-4 by test_torch_conformer.py.
KEY_BIAS = {"conformer.layers.*.k.b": 1e-3}


def _jax_tree(encoder_type, K, C, H=32):
    cfg = {**SMALL, "encoder_type": encoder_type}
    if encoder_type == "conformer":
        jcfg = JConformerConfig(hidden_size=H, num_layers=1, num_heads=2,
                                conv_kernel=31)
        enc = {"conformer": jconf_init(jax.random.PRNGKey(2), jcfg)}
    else:
        jcfg = JTConfig(hidden_size=H, num_layers=1, num_heads=2,
                        num_kv_heads=2, head_dim=H // 2, intermediate_size=64,
                        act="gelu", norm="layernorm", causal=False)
        enc = {"encoder": jt_init(jax.random.PRNGKey(2), jcfg)}
    rows = sum(C) if isinstance(C, tuple) else K * C
    tree = {"embedding": {"table": jnp.zeros((rows, H))},
            "pool": {"logits": jnp.zeros((K,))},
            "head": {"w": jnp.zeros((H, rows)), "b": jnp.zeros((rows,))},
            **enc}
    return cfg, jcfg, jax.tree.map(np.asarray, redraw(tree, 3))


@pytest.mark.parametrize("encoder_type", ["transformer", "conformer"])
@pytest.mark.parametrize("C", [32, (32, 20, 9)])
def test_se_forward_matches_jax(encoder_type, C):
    K = 3
    cfg, jcfg, tree = _jax_tree(encoder_type, K, C)
    sizes = C if isinstance(C, tuple) else (C,) * K
    rng = np.random.default_rng(4)
    toks = np.stack([rng.integers(0, c, (2, 23)) for c in sizes], -1)
    want = jse.se_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                          jcfg, vocab_size=C, num_codebooks=K)
    cfg_t = se.encoder_config(cfg)
    model = se.token_model_from_jax(tree, K, C, cfg_t, device="cpu")
    with torch.no_grad():
        got = se.se_forward(model, torch.from_numpy(toks), vocab_size=C,
                            num_codebooks=K)
    want = np.asarray(want)
    assert got.shape == want.shape
    # the -1e9 fill of heterogeneous vocabs is compared as it is
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want[want > -1e8]).max())
    init = se.init_token_model(torch.Generator().manual_seed(0), K, C, cfg_t)
    shapes = {k: v.shape for k, v in flatten_tree(
        to_jax_params(init.state_dict(), init)).items()}
    assert shapes == {k: v.shape for k, v in flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("se_inputs")))


@pytest.mark.parametrize("encoder_type,compute_ref", [
    ("transformer", True), ("conformer", False)])
def test_run_se_matches_jax(tmp_path, monkeypatch, inputs, encoder_type,
                            compute_ref):
    cfg = base_cfg(inputs, tmp_path / "jax", encoder_type=encoder_type,
                   compute_ref_metrics=compute_ref, **SMALL)
    want, init = run_jax_capturing_init(monkeypatch, jse.run_se, cfg)
    got = se.run_se({**cfg, "output_folder": str(tmp_path / "port")},
                    device="cpu", init_params=init)
    assert_same_summary(got, want)
    if compute_ref:
        assert "RecSTOI" in got and "RefDNSMOS" in got
    loose = KEY_BIAS if encoder_type == "conformer" else None
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                        token_cache=False, loose=loose)
