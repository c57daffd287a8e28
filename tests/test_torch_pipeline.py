"""Port parity for GPipe pipeline parallelism
(``audiocodecs_tpu_torch/parallel/pipeline.py``) against the JAX package,
on the CPU.

* ``stack_pipeline_stages`` equal to the reference's, leaf for leaf, at
  S = 1, 2 and 4 on numpy and on tensor leaves, and ``unstack`` its exact
  inverse; an indivisible stage count refused.
* The GPipe step on gloo ranks, (data, model) = (2, 2) with M = 2 and
  (1, 2) with M = 4, remat on in one: the loss of two steps within 1e-5
  relative of the reference's pipelined step (``make_pp_slm_train_step``
  on the same mesh shape), the first step's gradients within 1e-5 of each
  leaf's largest against ``jax.grad`` of the reference's pipelined loss
  (unstacked); a batch that does not divide into the microbatches
  refused; the gathered checkpoint tree in the stacked layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.parallel import pipeline as jpipe
from audiocodecs_tpu_torch.parallel import mesh as pmesh
from audiocodecs_tpu_torch.parallel import pipeline
from audiocodecs_tpu_torch.params import flatten_tree
import torch_dist_workers as workers
from zoo_pairs import one_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=16, num_codebooks=2, hidden_size=32, num_layers=4,
          num_heads=4, num_kv_heads=2, intermediate_size=64)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jllama.LlamaConfig(**KW)))


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_stack_and_unstack_are_the_reference_and_exact(tree, S, leaves):
    want = flatten_tree(jax.tree.map(
        np.asarray, jpipe.stack_pipeline_stages(tree, S)))
    src = tree if leaves == "numpy" else jax.tree.map(torch.tensor,
                                                      tree)
    stacked = pipeline.stack_pipeline_stages(src, S)
    got = flatten_tree(stacked)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]), w), k
    back = flatten_tree(pipeline.unstack_pipeline_stages(stacked))
    orig = flatten_tree(tree)
    assert sorted(back) == sorted(orig)
    for k, w in orig.items():
        assert np.array_equal(np.asarray(back[k]), w), k


def test_stack_refuses_an_indivisible_stage_count(tree):
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        pipeline.stack_pipeline_stages(tree, 3)


def _batch(B, L, seed=3):
    lcfg = jllama.LlamaConfig(**KW)
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, lcfg.vocab_size, (B, L)).astype(np.int64)
    flat[:, 0] = lcfg.bos_token
    mask = np.ones((B, L), np.float32)
    mask[:, 0] = 0.0
    mask[1, L // 2:] = 0.0
    flat[1, L // 2:] = lcfg.pad_token
    return flat, mask


@pytest.mark.parametrize("shape,M,remat", [((2, 2), 2, False),
                                           ((1, 2), 4, True)])
def test_gpipe_step_matches_the_reference(tree, shape, M, remat):
    kw = dict(KW, remat=remat)
    lcfg = jllama.LlamaConfig(**kw)
    n, S = int(np.prod(shape)), shape[1]
    flat, mask = _batch(8, 12)
    grid = np.asarray(jax.devices("cpu")[:n]).reshape(shape)
    mesh = jax.sharding.Mesh(grid, ("data", "model"))
    opt = optax.adam(1e-3)
    step, loss_fn = jpipe.make_pp_slm_train_step(lcfg, opt, mesh, M)
    with jax.set_mesh(mesh):
        pp = jpipe.shard_pp_llama_params(jpipe.stack_pipeline_stages(
            jax.tree.map(jnp.asarray, tree), S), mesh)
        st = opt.init(pp)
        f, m = jnp.asarray(flat.astype(np.int32)), jnp.asarray(mask)
        jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
            pp, f, m))
        want = []
        jstep = jax.jit(step)
        for _ in range(2):
            pp, st, loss = jstep(pp, st, f, m)
            want.append(float(loss))
    jgrads = flatten_tree(jpipe.unstack_pipeline_stages(jgrads))
    out = pmesh.spawn_ranks(workers.pp_steps, n, shape, kw, tree, flat,
                            mask, M)
    for o in out:
        for a, b in zip(o["losses"], want):
            assert abs(a - b) <= 1e-5 * abs(b)
        assert "does not divide into" in o["refused"]
    got = {}
    for o in out[:S]:  # data row 0: the S stages
        got.update(o["grads"])
    assert sorted(got) == sorted(jgrads)
    for k, w in jgrads.items():
        assert np.abs(got[k] - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                       1e-30), k
    # the embedding's gradient is summed over the ring: every stage has it
    for o in out[1:S]:
        assert np.array_equal(o["grads"]["embedding.table"],
                              out[0]["grads"]["embedding.table"])
    stacked = flatten_tree(jpipe.stack_pipeline_stages(tree, S))
    assert out[0]["stacked"] == {k: v.shape for k, v in stacked.items()}
