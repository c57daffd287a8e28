"""GPipe pipeline parallelism for the SLM decoder.

Counterpart of ``audiocodecs_tpu/parallel/pipeline.py``: the decoder's
layers are split into ``S`` contiguous stages along the ``model`` axis (so
dp×pp shares the ``(data, model)`` mesh of dp×tp), and ``M`` microbatches
flow through them.

* A stage's weights are its rank's own: :func:`stack_pipeline_stages`
  stacks the reference tree's layers into ``[S, L/S, ...]`` leaves (the
  reference's layout, which checkpoints keep) and
  :func:`shard_pp_llama_params` gives each rank its stage
  (:class:`PipelineLlama`).
* The schedule is the reference's, tick for tick: ``M + S − 1`` ticks; at
  each, stage 0 takes the next microbatch, every stage applies its layers,
  and the activations move one stage along the ring
  (:func:`..comm.ring_permute`, point-to-point sends). Bubbles compute on
  stale data and are discarded. The last stage's outputs are then summed
  over the ring (every other stage contributes zeros), so every stage
  holds them.
* Embedding, final norm and head run outside the pipeline, on every stage.
* The backward is autograd's, through the permutes: each microbatch's
  stage output is backpropagated with the gradient received from the next
  stage, tick by tick in reverse, as the permutes' gradients travel back
  along the ring. Every rank builds the same graph (the stage choices are
  ``torch.where`` on the rank's index, not branches), so every rank runs
  the same permutes in the same order. The embedding's gradient, nonzero
  on stage 0 only, is summed over the ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audiocodecs_tpu_torch.parallel.comm import (
    all_gather_cat,
    all_reduce,
    reduce_from,
    ring_permute,
)
from audiocodecs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_ranks,
    axis_size,
)
from audiocodecs_tpu_torch.parallel.train import ShardedModule, _masked_ce

__all__ = ["PipelineLlama", "make_pp_slm_loss", "make_pp_slm_train_step",
           "shard_pp_llama_params", "stack_pipeline_stages",
           "unstack_pipeline_stages"]


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(trees)


def _map(fn, tree):
    return _zip_map(lambda xs: fn(xs[0]), [tree])


def _stack(xs):
    return (torch.stack(xs) if isinstance(xs[0], torch.Tensor)
            else np.stack([np.asarray(x) for x in xs]))


def stack_pipeline_stages(params: dict, num_stages: int) -> dict:
    """The reference's Llama tree (numpy or tensor leaves) in pipeline
    form: its per-layer dicts stacked leaf-wise into ``[S, L/S, ...]``
    under ``body.stages``; final norm, embedding and head carried over."""
    layers = params["body"]["layers"]
    L = len(layers)
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} stages")
    stacked = _map(lambda x: x.reshape((num_stages, L // num_stages)
                                       + tuple(x.shape[1:])),
                   _zip_map(_stack, layers))
    return {"body": {"stages": stacked,
                     "final_norm": params["body"]["final_norm"]},
            "embedding": params["embedding"], "head": params["head"]}


def _stage_count(pp_params: dict) -> tuple:
    lead = pp_params["body"]["stages"]
    while isinstance(lead, (dict, list, tuple)):
        lead = next(iter(lead.values())) if isinstance(lead, dict) \
            else lead[0]
    return int(lead.shape[0]), int(lead.shape[1])


def unstack_pipeline_stages(pp_params: dict) -> dict:
    """Inverse of :func:`stack_pipeline_stages`: the per-layer list form
    that ``llama_forward`` and ``llama_generate`` read."""
    S, Ls = _stage_count(pp_params)
    flat = _map(lambda x: x.reshape((S * Ls,) + tuple(x.shape[2:])),
                pp_params["body"]["stages"])
    layers = [_map(lambda x, i=i: x[i], flat) for i in range(S * Ls)]
    return {"body": {"layers": layers,
                     "final_norm": pp_params["body"]["final_norm"]},
            "embedding": pp_params["embedding"], "head": pp_params["head"]}


class PipelineLlama(ShardedModule):
    """One rank's stage of the pipelined decoder: ``local`` is a ``Llama``
    of the stage's ``L/S`` layers with the whole embedding, final norm and
    head. The stage's layers are distinct on each rank of the pipeline
    axis; the embedding's gradient is summed over it."""

    def __init__(self, pp_params: dict, mesh, lcfg, device=None):
        super().__init__(mesh)
        from audiocodecs_tpu_torch.downstream.models.llama import (
            llama_from_jax)

        S = axis_size(mesh, MODEL_AXIS)
        stages, Ls = _stage_count(pp_params)
        if stages != S:
            raise ValueError(
                f"stage stack has {stages} stages but mesh axis "
                f"{MODEL_AXIS!r} has {S} devices — re-run "
                f"stack_pipeline_stages with num_stages={S}")
        self.cfg = lcfg
        pp_params = _map(_numpy, pp_params)
        s = axis_index(mesh, MODEL_AXIS)
        tree = unstack_pipeline_stages(pp_params)
        tree["body"]["layers"] = tree["body"]["layers"][s * Ls:(s + 1) * Ls]
        if device is None:
            device = ("cuda" if mesh.device_type == "cuda" else "cpu")
        self.local = llama_from_jax(
            tree, dataclasses.replace(lcfg, num_layers=Ls), device)
        for name, _ in self.named_parameters():
            if name.startswith("local.body.layers."):
                self.split_axes[name] = 0
        self.sum_over_model.add("local.embedding.table")

    def jax_tree(self):
        """The whole stacked tree (``[S, L/S, ...]`` stage leaves), on
        every rank."""
        from audiocodecs_tpu_torch.params import to_jax_params

        own = to_jax_params(self.local.state_dict(), self.local)
        dev = next(self.parameters()).device
        group = self.model_group
        stages = _map(lambda x: all_gather_cat(
            torch.from_numpy(np.asarray(x)).to(dev), group, 0).cpu().numpy(),
            stack_pipeline_stages(own, 1)["body"]["stages"])
        return {"body": {"stages": stages,
                         "final_norm": own["body"]["final_norm"]},
                "embedding": own["embedding"], "head": own["head"]}

    @torch.no_grad()
    def load_jax_tree(self, tree) -> None:
        fresh = PipelineLlama(tree, self.mesh, self.cfg,
                              next(self.parameters()).device)
        self.local.load_state_dict(fresh.local.state_dict(), strict=True)

    def full_module(self):
        """The whole decoder (the per-layer form) on every rank."""
        from audiocodecs_tpu_torch.downstream.models.llama import (
            llama_from_jax)

        return llama_from_jax(unstack_pipeline_stages(self.jax_tree()),
                              self.cfg, next(self.parameters()).device)


def _numpy(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def shard_pp_llama_params(pp_params: dict, mesh, lcfg, device=None):
    """This rank's stage of the stacked tree ``pp_params``
    (:class:`PipelineLlama`). The stage count must equal the ``model``
    axis's size: anything else would skip layers in the schedule."""
    return PipelineLlama(pp_params, mesh, lcfg, device)


def make_pp_slm_loss(lcfg, mesh, num_microbatches: int):
    """The pipeline-parallel SLM loss ``(stage, flat, mask) → share``:
    the K-interleaved next-token CE of :func:`..train.slm_interleaved_ce`
    with the decoder's depth run as an ``S``-stage, ``num_microbatches``-
    deep GPipe schedule on ``model``. ``stage`` is a :class:`PipelineLlama`;
    ``flat``/``mask`` are this rank's rows (every row when its
    ``data_split`` is False), which must divide by the microbatches; the
    share's mean over ``data`` is the global batch's loss."""
    from audiocodecs_tpu_torch.downstream.models.llama import llama_embed
    from audiocodecs_tpu_torch.downstream.models.multihead import (
        multihead_logits)
    from audiocodecs_tpu_torch.nn.transformer import (
        _norm, apply_layer, causal_mask, remat_layer, rope_cos_sin)

    tcfg = lcfg.transformer()
    S, M = axis_size(mesh, MODEL_AXIS), num_microbatches
    K, C = lcfg.num_codebooks, lcfg.vocab_size
    ring = axis_ranks(mesh, MODEL_AXIS)
    idx = axis_index(mesh, MODEL_AXIS)

    def loss_fn(stage: PipelineLlama, flat, mask):
        B, L = flat.shape
        if B % M:
            raise ValueError(f"batch of {B} rows per data rank does not "
                             f"divide into {M} microbatches")
        local = stage.local
        embs = llama_embed(local, flat, lcfg)
        embs_mb = embs.reshape(M, B // M, L, embs.shape[-1])
        cos, sin = rope_cos_sin(torch.arange(L, device=flat.device),
                                tcfg.head_dim, tcfg.rope_theta)
        att = causal_mask(L, L, tcfg.sliding_window, flat.device)[
            None, None, None]
        first = torch.tensor(idx == 0, device=flat.device)
        last = torch.tensor(idx == S - 1, device=flat.device)

        def stage_apply(x):
            for p in local.body.layers:
                x = (remat_layer(apply_layer, x, p, tcfg, cos, sin, att)
                     if tcfg.remat else
                     apply_layer(x, p, tcfg, cos, sin, att))
            return x

        state = torch.zeros_like(embs_mb[0])
        outs = [torch.zeros_like(embs_mb[0]) for _ in range(M)]
        for t in range(M + S - 1):
            state = torch.where(first, embs_mb[min(t, M - 1)], state)
            state = stage_apply(state)
            o = t - (S - 1)
            if o >= 0:
                outs[o] = torch.where(last, state, outs[o])
            if t < M + S - 2:
                state = ring_permute(state, ring)
        # only the last stage holds real outputs: sum them over the ring
        h = torch.stack(outs)
        h = reduce_from(torch.where(last, h, torch.zeros_like(h)),
                        axis_group(mesh, MODEL_AXIS)).reshape(B, L, -1)
        h = _norm(h, local.body.final_norm, tcfg.norm, tcfg.norm_eps)
        logits = multihead_logits({"w": local.head.w}, h, num_heads=K)
        pos = torch.arange(L - 1, device=flat.device)
        total = _masked_ce(logits[:, pos, pos % K], flat[:, 1:],
                           mask[:, 1:], K, C).sum()
        count, ranks = mask[:, 1:].sum(), 1
        if stage.data_split:
            count = all_reduce(count, axis_group(mesh, DATA_AXIS))
            ranks = axis_size(mesh, DATA_AXIS)
        return total / torch.clamp(count, min=1.0) * ranks

    return loss_fn


def make_pp_slm_train_step(lcfg, optimizer: torch.optim.Optimizer, mesh,
                           num_microbatches: int):
    """``(step, loss_fn)``: ``step(stage, flat, mask) → loss`` runs
    :func:`make_pp_slm_loss` on this rank's rows of the global batch
    (the rows must divide by ``data`` and then by the microbatches), its
    gradient (averaged over ``data``, the embedding's summed over the
    ring) and ``optimizer``'s update; the loss returned is the global
    batch's."""
    from audiocodecs_tpu_torch.parallel.mesh import shard_batch

    loss_fn = make_pp_slm_loss(lcfg, mesh, num_microbatches)

    def step(stage, flat, mask):
        optimizer.zero_grad(set_to_none=True)
        flat, mask = shard_batch(mesh, (flat, mask),
                                 next(stage.parameters()).device)
        stage.data_split = True
        loss = loss_fn(stage, flat, mask)
        loss.backward()
        stage.reduce_grads()
        optimizer.step()
        return stage.batch_mean(loss)

    return step, loss_fn
