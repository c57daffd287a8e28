"""Port parity for the switch-MoE FFN and expert parallelism
(``audiocodecs_tpu_torch/parallel/moe.py``, the MoE FFN and remat of
``nn/transformer.py`` and ``downstream/models/llama.py``) against the JAX
package, on the CPU.

* ``_route``: dispatch exact and combine within 1e-6 against the
  reference's for switch top-1 and GShard top-2, with capacity drops; the
  aux loss within 1e-6 relative. Routed over 4 data ranks (gloo), each
  rank's rows of the global dispatch and combine, and its aux shares sum
  to the global aux.
* ``moe_ffn_dense_aux``: output and every gradient against ``jax.grad``.
* ``make_moe_train_step`` on 4 ranks, (data, model) = (2, 2): the loss
  within 1e-5 relative of the reference's shard_map step and each leaf's
  gradient, the replicated router's included, within 1e-5 of its largest
  against ``jax.grad`` of the reference's sharded loss.
* The MoE Llama (top-1 and top-2 with drops, the aux weight on): logits,
  aux, every gradient and greedy generation against the reference; remat
  changes no gradient.
* The expert-parallel SLM step on 4 ranks against the unsharded reference
  (GSPMD keeps the unsharded routing): the loss with the weighted aux and
  each gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.parallel import mesh as jmesh
from audiocodecs_tpu.parallel import moe as jmoe
from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu_torch.downstream.models import llama
from audiocodecs_tpu_torch.parallel import mesh as pmesh
from audiocodecs_tpu_torch.parallel import moe
from audiocodecs_tpu_torch.params import flatten_tree, to_jax_params
import torch_dist_workers as workers
from zoo_pairs import one_thread  # noqa: F401 (autouse)

ROUTES = [dict(num_experts=4, capacity_factor=1.0, top_k=1),
          dict(num_experts=4, capacity_factor=0.75, top_k=2)]


def _case(cfg_kw, N=24, D=8, seed=0):
    cfg = dict(hidden_size=D, ffn_size=16, **cfg_kw)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), jmoe.MoEConfig(**cfg)))
    x = np.random.default_rng(seed).standard_normal((N, D)).astype(
        np.float32)
    return cfg, params, x


@pytest.mark.parametrize("cfg_kw", ROUTES)
def test_route_is_the_reference_routing(cfg_kw):
    cfg, params, x = _case(cfg_kw)
    jd, jc, jaux = jmoe._route(params, jnp.asarray(x), jmoe.MoEConfig(**cfg))
    d, c, aux = moe._route(torch.tensor(params["router"]),
                           torch.from_numpy(x), moe.MoEConfig(**cfg))
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # capacity drops happen: some token holds fewer than top_k slots
    assert (np.asarray(jd).sum((1, 2)) < cfg["top_k"]).any()


@pytest.mark.parametrize("cfg_kw", ROUTES)
def test_route_over_data_ranks_is_the_global_routing(cfg_kw):
    cfg, params, x = _case(cfg_kw)
    jd, jc, jaux = jmoe._route(params, jnp.asarray(x), jmoe.MoEConfig(**cfg))
    out = pmesh.spawn_ranks(workers.route, 4, 4, params["router"], x, cfg)
    assert np.array_equal(np.concatenate([o["dispatch"] for o in out]),
                          np.asarray(jd))
    np.testing.assert_allclose(np.concatenate([o["combine"] for o in out]),
                               np.asarray(jc), rtol=1e-6, atol=1e-7)
    assert abs(sum(o["aux"] for o in out) - float(jaux)) <= 1e-6 * float(
        jaux)


@pytest.mark.parametrize("cfg_kw", ROUTES)
def test_moe_ffn_dense_and_its_gradients(cfg_kw):
    cfg, params, x = _case(cfg_kw)
    jcfg, pcfg = jmoe.MoEConfig(**cfg), moe.MoEConfig(**cfg)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn_dense_aux(p, x, jcfg)
        return jnp.sum(out ** 2) + aux, out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                        has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_ffn_dense_aux(p, xt, pcfg)
    (torch.sum(out ** 2) + aux).backward()
    top = np.abs(np.asarray(jout)).max()
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 1e-5 * top
    for k in params:
        want = np.asarray(jg[0][k])
        assert np.abs(p[k].grad.numpy() - want).max() <= 1e-5 * np.abs(
            want).max(), k
    want = np.asarray(jg[1])
    assert np.abs(xt.grad.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(moe.moe_ffn_dense(p, xt, pcfg), out)


def test_expert_parallel_step_matches_the_reference():
    cfg = dict(hidden_size=8, ffn_size=16, num_experts=4,
               capacity_factor=1.0, top_k=2)
    jcfg = jmoe.MoEConfig(**cfg)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 8)).astype(np.float32)
    mesh = jmesh.make_mesh(4, model_parallel=2, backend="cpu")
    import optax

    step, loss_fn, _ = jmoe.make_moe_train_step(jcfg, optax.sgd(0.0), mesh)
    with jax.set_mesh(mesh):
        sp = jmoe.shard_moe_params(params, mesh)
        xs, ys = jmesh.shard_batch(mesh, x), jmesh.shard_batch(mesh, y)
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(sp, xs, ys)
        jgrads = jax.tree.map(np.asarray, jgrads)
    out = pmesh.spawn_ranks(workers.moe_step, 4, (2, 2), cfg, params, x, y)
    grads = workers.assemble(out, 2)
    for o in out:
        assert abs(o["loss"] - float(jloss)) <= 1e-5 * float(jloss)
    for k in ("router", "w_in", "w_out"):
        want = jgrads[k]
        assert np.abs(grads[k] - want).max() <= 1e-5 * np.abs(want).max(), k
    # the router's gradient sums every model rank's experts' part once
    assert np.abs(out[0]["grads"]["router"][0] - out[1]["grads"]["router"][
        0]).max() == 0.0


def _moe_llama(top_k, cf, remat=False, aux_weight=0.01):
    kw = dict(vocab_size=17, num_codebooks=2, hidden_size=32, num_layers=2,
              num_heads=4, num_kv_heads=2, intermediate_size=64,
              max_seq_len=64, moe_experts=4, moe_capacity_factor=cf,
              moe_top_k=top_k, moe_aux_weight=aux_weight)
    jc = jllama.LlamaConfig(**kw)
    tree = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(0), jc))
    return kw, jc, tree


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (2, 0.75)])
def test_moe_llama_forward_gradients_and_generation(top_k, cf):
    kw, jc, tree = _moe_llama(top_k, cf)
    toks = np.random.default_rng(0).integers(0, 17, (3, 9))
    toks[:, 0] = jc.bos_token

    def jloss(p):
        lg, aux = jllama.llama_forward(
            p, jllama.llama_embed(p, jnp.asarray(toks), jc), jc,
            return_aux=True)
        return jnp.mean(lg ** 2) + jc.moe_aux_weight * aux, (lg, aux)

    (_, (jlg, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    jg = flatten_tree(jax.tree.map(np.asarray, jg))
    for remat in (False, True):
        cfg = llama.LlamaConfig(**kw, remat=remat)
        model = llama.llama_from_jax(tree, cfg, "cpu")
        lg, aux = llama.llama_forward(
            model, llama.llama_embed(model, torch.from_numpy(toks), cfg),
            cfg, return_aux=True)
        (torch.mean(lg ** 2) + cfg.moe_aux_weight * aux).backward()
        assert np.abs(lg.detach().numpy() - np.asarray(jlg)).max() \
            <= 1e-5 * np.abs(np.asarray(jlg)).max()
        assert abs(float(aux.detach()) - float(jaux)) <= 1e-6 * float(jaux)
        got = flatten_tree(to_jax_params(
            {k: p.grad for k, p in model.named_parameters()}, model))
        assert sorted(got) == sorted(jg)
        for k, want in jg.items():
            assert np.abs(got[k] - want).max() <= 1e-5 * max(
                np.abs(want).max(), 1e-30), (remat, k)
    prompt = toks[:, :5]
    want, wl = jllama.llama_generate(jax.tree.map(jnp.asarray, tree), jc,
                                     jnp.asarray(prompt), 8,
                                     jax.random.PRNGKey(0))
    got, gl = llama.llama_generate(model, cfg, torch.from_numpy(prompt), 8)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gl.numpy(), np.asarray(wl))


def test_expert_parallel_slm_loss_with_aux_matches_the_reference():
    kw, jc, tree = _moe_llama(2, 0.75)
    rng = np.random.default_rng(2)
    flat = rng.integers(0, 17, (8, 12)).astype(np.int64)
    flat[:, 0] = jc.bos_token
    mask = np.ones((8, 12), np.float32)
    mask[:, 0] = 0.0
    mask[3, 7:] = 0.0

    def jloss(p):
        logits, aux = jllama.llama_forward(
            p, jllama.llama_embed(p, jnp.asarray(flat), jc), jc,
            return_aux=True)
        return jtrain.slm_interleaved_ce(
            logits, jnp.asarray(flat), jnp.asarray(mask), 2, 17) \
            + jc.moe_aux_weight * aux

    jv, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree))
    jg = flatten_tree(jax.tree.map(np.asarray, jg))
    out = pmesh.spawn_ranks(workers.slm_steps, 4, (2, 2), ("data", "model"),
                            kw, tree, flat, mask, 1, "ep", None, True)
    for o in out:
        assert abs(o["losses"][0] - float(jv)) <= 1e-5 * float(jv)
    grads = workers.assemble(out, 2)
    assert {k for k, (_, a) in out[0]["grads"].items() if a is not None} \
        == {f"body.layers.{i}.moe.{n}" for i in range(2)
            for n in ("w_in", "w_out")}
    for k, want in jg.items():
        assert np.abs(grads[k] - want).max() <= 1e-5 * max(
            np.abs(want).max(), 1e-30), k


def test_moe_config_matches_the_reference():
    kw = dict(hidden_size=8, ffn_size=16, num_experts=4)
    for cf in (0.1, 1.0, 2.5):
        for n in (1, 7, 64):
            assert moe.MoEConfig(**kw, capacity_factor=cf).capacity(n) \
                == jmoe.MoEConfig(**kw, capacity_factor=cf).capacity(n)
    assert [f.name for f in dataclasses.fields(moe.MoEConfig)] == [
        f.name for f in dataclasses.fields(jmoe.MoEConfig)]
    shapes = {k: tuple(v.shape) for k, v in moe.init_moe_params(
        torch.Generator().manual_seed(0), moe.MoEConfig(**kw)).items()}
    assert shapes == {k: tuple(v.shape) for k, v in jmoe.init_moe_params(
        jax.random.PRNGKey(0), jmoe.MoEConfig(**kw)).items()}
