"""Rank workers of the parallel layer's CPU tests.

Each function runs in a process of its own that
``audiocodecs_tpu_torch.parallel.mesh.spawn_ranks`` starts and joins to a
gloo group (one intra-op thread each); this module imports ``torch``,
``numpy`` and the port only, so the spawned children never import JAX.
The parent process holds the JAX references and compares. A worker
returns what its rank holds (its shards with the axis each is split on),
and :func:`assemble` rebuilds the whole tensors in the parent.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from audiocodecs_tpu_torch.parallel import mesh as pmesh


def grads_of(holder) -> dict:
    """``{name: (grad as numpy, model axis or None)}`` of a sharded
    module's parameters, ``local.`` and ``shards.`` prefixes dropped."""
    out = {}
    for name, p in holder.named_parameters():
        key = name.split(".", 1)[1].replace("__", ".")
        g = None if p.grad is None else p.grad.detach().numpy().copy()
        out[key] = (g, holder.split_axes.get(name))
    return out


def assemble(per_rank: list, mp: int, key: str = "grads") -> dict:
    """The whole tensors from the ranks' ``key`` entries: a split one
    concatenated over the model ranks of data row 0 (ranks 0..mp-1)."""
    out = {}
    for name, (g, axis) in per_rank[0][key].items():
        if axis is None or g is None:
            out[name] = g
        else:
            out[name] = np.concatenate(
                [per_rank[r][key][name][0] for r in range(mp)], axis=axis)
    return out


def mesh_info(rank: int, shape: tuple, names: tuple) -> dict:
    mp = shape[-1]
    sp = shape[1] if len(shape) == 3 else 1
    m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=mp,
                        axis_names=names, device="cpu", seq_parallel=sp)
    batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3),
             "y": [np.arange(8), np.arange(16).reshape(8, 2)]}
    placed = pmesh.shard_batch(m, batch)
    return {
        "sizes": {n: pmesh.axis_size(m, n) for n in names},
        "index": {n: pmesh.axis_index(m, n) for n in names},
        "ranks": {n: pmesh.axis_ranks(m, n) for n in names},
        "x": placed["x"].numpy(), "y1": placed["y"][1].numpy(),
        "contiguous": placed["x"].is_contiguous(),
        "slice": pmesh.local_batch_slice(8, m),
        "placements": [type(p).__name__ for p in pmesh.data_sharding(m)],
        "replicated": [type(p).__name__ for p in pmesh.replicated(m)],
        "main": pmesh.is_main_process(),
        "gathered": pmesh.data_parallel(
            lambda t: t * 2, m, np.arange(8.0)[:, None]).numpy(),
    }


def _tiny_codec(state: dict):
    from audiocodecs_tpu_torch.models.encodec import (
        Encodec, EncodecModelConfig)

    cfg = EncodecModelConfig(sampling_rate=800, num_filters=8,
                             hidden_size=16, upsampling_ratios=(4, 2),
                             codebook_size=64, codebook_dim=16,
                             num_quantizers=4)
    return Encodec(800, 800, model_config=cfg, num_codebooks=4,
                   device="cpu", state_dict={
                       k: torch.from_numpy(v) for k, v in state.items()})


def codec_steps(rank: int, shape: tuple, state: dict, batches: list,
                sharded: bool = True) -> dict:
    """Codec steps of the tiny EnCodec (Adam 1e-3, EMA codebooks): the
    metrics of each, the first step's gradients and the params after."""
    from audiocodecs_tpu_torch.parallel.train import (
        init_codec_opt_state, make_codec_train_step, shard_codec_params)

    model = _tiny_codec(state)
    if sharded:
        m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=shape[1],
                            device="cpu")
        model = shard_codec_params(model, m)
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    st = init_codec_opt_state(opt, model, 4)
    step = make_codec_train_step(model, 4, commit_warmup=1)
    metrics, grads = [], None
    for i, b in enumerate(batches):
        metrics.append({k: float(v) for k, v in step(st, b).items()})
        if i == 0:
            grads = (grads_of(model) if sharded else {
                n: (None if p.grad is None else p.grad.numpy().copy(), None)
                for n, p in model.named_parameters()})
    full = model.full_module() if sharded else model
    return {"metrics": metrics, "grads": grads,
            "params": {n: p.detach().numpy().copy()
                       for n, p in full.named_parameters()}}


def serve(rank: int, shape: tuple, state: dict, sig: np.ndarray) -> dict:
    m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=shape[1],
                        device="cpu")
    codec = _tiny_codec(state)
    with torch.no_grad():
        toks = pmesh.data_parallel(codec.sig_to_toks, m, sig)
        rec = pmesh.data_parallel(codec.toks_to_sig, m, toks)
    return {"toks": toks.numpy(), "rec": rec.numpy()}


def _llama(kw: dict, tree):
    from audiocodecs_tpu_torch.downstream.models.llama import (
        LlamaConfig, llama_from_jax)

    return llama_from_jax(tree, LlamaConfig(**kw), "cpu")


def slm_steps(rank: int, shape: tuple, names: tuple, kw: dict, tree,
              flat, mask, steps: int = 2, mode: str = "tp",
              sequence_axis=None, with_aux: bool = False) -> dict:
    """SLM steps of the sharded decoder (Adam 1e-3): the global losses,
    the first step's gradients (``with_aux``: of the recipe's loss with
    the MoE aux, through ``nll``) and the rank's shards after."""
    from audiocodecs_tpu_torch.parallel.train import (
        ShardedLlama, make_slm_train_step)

    sp = shape[1] if len(shape) == 3 else 1
    m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=shape[-1],
                        axis_names=names, device="cpu", seq_parallel=sp)
    holder = ShardedLlama(_llama(kw, tree), m, mode=mode)
    opt = torch.optim.Adam(holder.parameters(), 1e-3)
    if with_aux:
        f, mk = pmesh.shard_batch(m, (flat, mask))
        loss = holder.nll(f, mk, with_aux=True)
        loss.backward()
        holder.reduce_grads()
        return {"losses": [float(holder.batch_mean(loss))],
                "grads": grads_of(holder)}
    step = make_slm_train_step(holder, opt, sequence_axis=sequence_axis)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(torch.as_tensor(flat),
                                 torch.as_tensor(mask))))
        if i == 0:
            grads = grads_of(holder)
    return {"losses": losses, "grads": grads,
            "tree_keys": sorted(_flat_keys(holder.jax_tree()))}


def _flat_keys(tree, prefix=""):
    from audiocodecs_tpu_torch.params import flatten_tree

    return flatten_tree(tree, prefix).keys()


def route(rank: int, n: int, router, x, cfg_kw: dict) -> dict:
    """This rank's rows of ``x`` routed over the data group (``n`` ranks
    on ``data``)."""
    from audiocodecs_tpu_torch.parallel.moe import MoEConfig, _route

    m = pmesh.make_mesh(n, model_parallel=1, device="cpu")
    xs = pmesh.shard_batch(m, x)
    d, c, aux = _route(torch.as_tensor(router), xs, MoEConfig(**cfg_kw),
                       pmesh.axis_group(m, pmesh.DATA_AXIS))
    return {"dispatch": d.numpy(), "combine": c.numpy(), "aux": float(aux)}


def moe_step(rank: int, shape: tuple, cfg_kw: dict, params: dict, x, y):
    """One step of ``make_moe_train_step`` (SGD at lr 0, so the params
    stay): the global loss and each leaf's gradient."""
    from audiocodecs_tpu_torch.parallel.moe import (
        MoEConfig, make_moe_train_step, shard_moe_params)

    m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=shape[1],
                        device="cpu")
    cfg = MoEConfig(**cfg_kw)
    local = shard_moe_params({k: torch.as_tensor(v)
                              for k, v in params.items()}, m)
    step, _, forward = make_moe_train_step(cfg, m)
    loss = step(local, torch.optim.SGD(local.values(), lr=0.0), x, y)
    axes = {"router": None, "w_in": 0, "w_out": 0}
    return {"loss": float(loss),
            "grads": {k: (p.grad.numpy().copy(), axes[k])
                      for k, p in local.items()}}


def pp_steps(rank: int, shape: tuple, kw: dict, tree, flat, mask,
             microbatches: int, steps: int = 2) -> dict:
    """GPipe steps: the global losses and the first step's gradients as
    ``{global name: grad}`` of this rank's stage (the embedding's is
    already summed over the ring)."""
    from audiocodecs_tpu_torch.downstream.models.llama import LlamaConfig
    from audiocodecs_tpu_torch.parallel.pipeline import (
        make_pp_slm_train_step, shard_pp_llama_params,
        stack_pipeline_stages)

    m = pmesh.make_mesh(int(np.prod(shape)), model_parallel=shape[1],
                        device="cpu")
    lcfg = LlamaConfig(**kw)
    stage = shard_pp_llama_params(stack_pipeline_stages(tree, shape[1]), m,
                                  lcfg)
    step, _ = make_pp_slm_train_step(
        lcfg, torch.optim.Adam(stage.parameters(), 1e-3), m, microbatches)
    losses, grads = [], {}
    Ls = len(stage.local.body.layers)
    s = pmesh.axis_index(m, pmesh.MODEL_AXIS)
    for i in range(steps):
        losses.append(float(step(stage, torch.as_tensor(flat),
                                 torch.as_tensor(mask))))
        if i == 0:
            for name, p in stage.local.named_parameters():
                if name.startswith("body.layers."):
                    _, _, j, rest = name.split(".", 3)
                    name = f"body.layers.{s * Ls + int(j)}.{rest}"
                grads[name] = p.grad.numpy().copy()
    refused = None
    try:
        step(stage, torch.as_tensor(flat[:2]), torch.as_tensor(mask[:2]))
    except ValueError as e:
        refused = str(e)
    return {"losses": losses, "grads": grads, "refused": refused,
            "stacked": {k: v.shape for k, v in dict(_flat_items(
                stage.jax_tree())).items()}}


def _flat_items(tree):
    from audiocodecs_tpu_torch.params import flatten_tree

    return flatten_tree(tree).items()


def trainer_steps(rank: int, shape: tuple, kw: dict, tree, batches: list,
                  out: str, max_grad_norm: float, sharder: str) -> dict:
    """Trainer steps of the SLM loss on a mesh (``model_parallel`` =
    ``shape[1]``) with ``sharder`` ("tp", "ep" or "" for data
    parallelism), a checkpoint saved and loaded back: the losses and the
    gathered tree after the steps."""
    from audiocodecs_tpu_torch.downstream.recipes.slm import next_token_nll
    from audiocodecs_tpu_torch.downstream.recipes.trainer import Trainer
    from audiocodecs_tpu_torch.parallel.moe import shard_moe_llama_params
    from audiocodecs_tpu_torch.parallel.train import shard_llama_params

    model = _llama(kw, tree)
    lcfg = model.cfg
    shard = {"tp": shard_llama_params, "ep": shard_moe_llama_params,
             "": None}[sharder]

    def loss_fn(m, batch, gen):
        if shard is None:
            return next_token_nll(m, batch["flat"], batch["mask"], lcfg,
                                  with_aux=True), {}
        return m.nll(batch["flat"], batch["mask"], with_aux=True), {}

    t = Trainer(loss_fn, model, lr=1e-3, output_folder=out,
                max_grad_norm=max_grad_norm, model_parallel=shape[1],
                param_sharder=shard)
    losses = []
    for b in batches:
        b = t._place_batch({k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(t.step(b, None)[0])
    t.save_checkpoint("latest")
    after = dict(_flat_items(t.jax_params()))
    t.load_checkpoint("latest")
    again = dict(_flat_items(t.jax_params()))
    return {"losses": losses, "params": after,
            "reloaded": all(np.array_equal(after[k], again[k])
                            for k in after),
            "mesh": dict(zip(t.mesh.mesh_dim_names, t.mesh.shape))}


def fit_then_load(rank: int, kw: dict, tree, batches: list, out: str,
                  epochs: int) -> dict:
    """``Trainer.fit`` on data parallelism alone (no sharder) with a
    metric that improves every epoch, so each epoch rewrites the best
    checkpoint, then ``load_checkpoint("best")`` at once into zeroed
    params: the params after ``fit`` and those loaded back. Rank 0 writes
    slowly, so a rank that does not wait for the write reads last epoch's
    file."""
    import time

    from audiocodecs_tpu_torch.downstream.recipes import trainer
    from audiocodecs_tpu_torch.downstream.recipes.slm import next_token_nll
    from audiocodecs_tpu_torch.downstream.recipes.trainer import Trainer

    if rank == 0:
        write = trainer.save_params

        def slow_write(path, tree):
            time.sleep(0.3)
            write(path, tree)

        trainer.save_params = slow_write
    model = _llama(kw, tree)
    lcfg = model.cfg
    t = Trainer(lambda m, b, g: (next_token_nll(m, b["flat"], b["mask"],
                                                lcfg), {}),
                model, lr=1e-3, output_folder=out)
    metrics = iter(range(epochs, 0, -1))
    t.fit(epochs, lambda: [{k: torch.as_tensor(v) for k, v in b.items()}
                           for b in batches],
          valid_fn=lambda params: next(metrics))
    after = dict(_flat_items(t.jax_params()))
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    t.load_checkpoint("best")
    return {"after": after, "loaded": dict(_flat_items(t.jax_params())),
            "mesh": dict(zip(t.mesh.mesh_dim_names, t.mesh.shape))}


def run_slm_rank(rank: int, cfg: dict, init) -> dict:
    """The SLM recipe on this rank (on the CPU)."""
    from audiocodecs_tpu_torch.downstream.recipes.slm import run_slm

    return run_slm(copy.deepcopy(cfg), device="cpu", init_params=init)


def refusals(rank: int) -> dict:
    """What a two-rank group refuses: a mesh of more ranks than the group,
    a model axis that does not divide it, experts that do not divide the
    model axis, a stage stack of the wrong count."""
    from audiocodecs_tpu_torch.downstream.models.llama import (
        Llama, LlamaConfig, init_llama_params)
    from audiocodecs_tpu_torch.parallel.moe import (
        MoEConfig, make_moe_train_step, shard_moe_llama_params)
    from audiocodecs_tpu_torch.parallel.pipeline import (
        shard_pp_llama_params, stack_pipeline_stages)
    from audiocodecs_tpu_torch.params import to_jax_params

    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)

    catch("more_ranks", lambda: pmesh.make_mesh(4, device="cpu"))
    catch("indivisible", lambda: pmesh.make_mesh(2, model_parallel=3,
                                                 device="cpu"))
    m = pmesh.make_mesh(2, model_parallel=2, device="cpu")
    catch("experts", lambda: make_moe_train_step(
        MoEConfig(num_experts=3), m))
    lcfg = LlamaConfig(vocab_size=8, num_codebooks=1, hidden_size=16,
                       num_layers=2, num_heads=2, num_kv_heads=1,
                       intermediate_size=16, moe_experts=3)
    model = Llama(lcfg)
    model.load_state_dict(init_llama_params(torch.Generator().manual_seed(0),
                                            lcfg))
    catch("ep_experts", lambda: shard_moe_llama_params(model, m))
    dense = dataclasses.replace(lcfg, moe_experts=0)
    model = Llama(dense)
    model.load_state_dict(init_llama_params(torch.Generator().manual_seed(0),
                                            dense))
    catch("stages", lambda: shard_pp_llama_params(stack_pipeline_stages(
        to_jax_params(model.state_dict(), model), 1), m, dense))
    catch("ep_dense", lambda: shard_moe_llama_params(model, m))
    return out
