"""Port parity for the trainer and the SLM recipe on a mesh, and the
multichip dry run (``audiocodecs_tpu_torch/downstream/recipes/{trainer,
slm}.py``, ``parallel/dryrun.py``) against the JAX package, on the CPU.

The port's ranks are gloo processes (``spawn_ranks``, workers in
``tests/torch_dist_workers.py``); the JAX runs use the 8-device virtual
CPU mesh of ``conftest.py``, so their data degree differs from the
port's while the math is the same.

* The trainer on 4 ranks against the reference's trainer on 8 devices,
  two steps with the clip active (``max_grad_norm`` 0.5): Megatron
  (``model_parallel: 2``), expert parallelism on the MoE decoder with the
  aux loss, and data parallelism alone on 2 ranks: losses within 1e-5
  relative, the params after within 1e-4 of each leaf's largest; the
  checkpoint, gathered whole and written by rank 0, loads back exactly.
* ``fit`` on 2 data-parallel ranks, then ``load_checkpoint("best")`` at
  once: every rank reads the checkpoint of the last epoch, whole.
* ``run_slm`` at ``model_parallel: 2`` and at ``pipeline_parallel: 2`` on
  2 ranks against the reference's run from the captured init: the best
  checkpoint within 1e-4 a leaf, the token cache equal, the summaries as
  ``recipe_pairs.assert_same_summary`` holds them.
* ``dryrun_multichip(4, device="cpu")`` passes and prints the reference's
  summary line; on CUDA without cards it raises.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from audiocodecs_tpu.downstream.models import llama as jllama
from audiocodecs_tpu.downstream.recipes import slm as jslm
from audiocodecs_tpu.downstream.recipes import trainer as jtrainer
from audiocodecs_tpu.parallel import moe as jmoe
from audiocodecs_tpu.parallel import train as jtrain
from audiocodecs_tpu_torch.parallel import mesh as pmesh
from audiocodecs_tpu_torch.parallel.dryrun import dryrun_multichip
from audiocodecs_tpu_torch.params import flatten_tree
from recipe_pairs import (
    assert_same_outputs,
    assert_same_summary,
    base_cfg,
    make_inputs,
    run_jax_capturing_init,
)
import torch_dist_workers as workers
from zoo_pairs import one_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=32, num_codebooks=2, hidden_size=64, num_layers=2,
          num_heads=4, num_kv_heads=2, intermediate_size=128)
MOE = dict(KW, moe_experts=4, moe_capacity_factor=1.0, moe_top_k=2,
           moe_aux_weight=0.01)


def _batches(lcfg, n=2, B=8, L=16, ragged=True):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        flat = rng.integers(0, lcfg.vocab_size, (B, L)).astype(np.int64)
        flat[:, 0] = lcfg.bos_token
        mask = np.ones((B, L), np.float32)
        mask[:, 0] = 0.0
        if ragged:
            for b in range(B):
                mask[b, L - b:] = 0.0
                flat[b, L - b:] = lcfg.pad_token
        out.append({"flat": flat, "mask": mask})
    return out


def _jax_nll(lcfg):
    def loss_fn(params, batch, key):
        logits, aux = jllama.llama_forward(
            params, jllama.llama_embed(params, batch["flat"], lcfg), lcfg,
            return_aux=True)
        loss = jtrain.slm_interleaved_ce(
            logits, batch["flat"], batch["mask"], lcfg.num_codebooks,
            lcfg.vocab_size)
        if lcfg.moe_experts > 0:
            loss = loss + lcfg.moe_aux_weight * aux
        return loss, {}
    return loss_fn


@pytest.mark.parametrize("kind,kw,n,mp", [
    ("tp", KW, 4, 2), ("ep", MOE, 4, 2), ("", KW, 2, 1)])
def test_trainer_on_a_mesh_matches_the_reference(tmp_path, kind, kw, n, mp):
    lcfg = jllama.LlamaConfig(**kw)
    tree = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(5), lcfg))
    # data parallelism alone averages the ranks' losses: equal masks
    batches = _batches(lcfg, ragged=bool(kind))
    sharder = {"tp": jtrain.shard_llama_params,
               "ep": jmoe.shard_moe_llama_params, "": None}[kind]
    jt = jtrainer.Trainer(_jax_nll(lcfg), jax.tree.map(jnp.asarray, tree),
                          lr=1e-3, output_folder=str(tmp_path / "jax"),
                          max_grad_norm=0.5, model_parallel=mp,
                          param_sharder=sharder)
    want = []
    for b in batches:
        b = jt._place_batch({k: jnp.asarray(v) for k, v in b.items()})
        jt.params, jt.opt_state, loss, _ = jt._step(
            jt.params, jt.opt_state, b, jax.random.PRNGKey(0))
        want.append(float(loss))
    jparams = flatten_tree(jax.tree.map(np.asarray, jt.params))
    out = pmesh.spawn_ranks(workers.trainer_steps, n, (n // mp, mp), kw,
                            tree, batches, str(tmp_path / "port"), 0.5,
                            kind)
    for o in out:
        assert o["reloaded"]
        assert o["mesh"] == {"data": n // mp, "model": mp}
        for a, b in zip(o["losses"], want):
            assert abs(a - b) <= 1e-5 * abs(b)
    got = out[0]["params"]
    assert sorted(got) == sorted(jparams)
    for k, w in jparams.items():
        assert np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "ckpt_latest.npz", "train_log.txt"]


def test_fit_then_load_reads_the_last_best_checkpoint_on_every_rank(
        tmp_path):
    lcfg = jllama.LlamaConfig(**KW)
    tree = jax.tree.map(np.asarray, jllama.init_llama_params(
        jax.random.PRNGKey(5), lcfg))
    out = pmesh.spawn_ranks(workers.fit_then_load, 2, KW, tree,
                            _batches(lcfg, ragged=False), str(tmp_path), 3)
    for o in out:
        assert o["mesh"] == {"data": 2, "model": 1}
        assert sorted(o["loaded"]) == sorted(o["after"])
        for k, v in o["after"].items():
            assert np.array_equal(o["loaded"][k], v), k
            assert np.array_equal(v, out[0]["after"][k]), k


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("parallel_inputs")))


SLM = dict(d_model=32, num_layers=2, num_heads=2, num_kv_heads=2,
           ffn_dim=64, max_flat_len=128, gen_frames=0, generate=False)


@pytest.mark.parametrize("extra", [
    dict(model_parallel=2),
    dict(pipeline_parallel=2, num_microbatches=1, batch_size=4,
         consistency_eval=False)])
def test_slm_recipe_on_two_ranks_matches_the_reference(tmp_path,
                                                       monkeypatch, inputs,
                                                       extra):
    cfg = base_cfg(inputs, tmp_path / "jax", **SLM, **extra)
    want, init = run_jax_capturing_init(monkeypatch, jslm.run_slm, cfg)
    monkeypatch.undo()
    port = dict(cfg, output_folder=str(tmp_path / "port"))
    got = pmesh.spawn_ranks(workers.run_slm_rank, 2, port, init)
    for summary in got:
        assert_same_summary(summary, want)
    assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    line = dryrun_multichip(4, device="cpu")
    assert line in capsys.readouterr().out
    m = re.fullmatch(
        r"dryrun_multichip\(4\) ok: codec_loss=(\S+) slm_loss=(\S+) "
        r"slm_sp_loss=nan slm_pp_loss=(\S+) moe_ep_loss=(\S+) "
        r"dp_serving=token-exact\(B=8\) tp/dp_loss_match=f32 "
        r"mesh=\{'data': 2, 'model': 2\}", line)
    assert m and all(np.isfinite(float(v)) for v in m.groups())


def test_dryrun_refuses_cuda_without_cards():
    with pytest.raises(ValueError, match="cards"):
        dryrun_multichip(2, device="cuda")
