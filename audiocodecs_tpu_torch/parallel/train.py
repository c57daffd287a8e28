"""Codec and SLM training steps, on one device or over a mesh.

Counterpart of ``audiocodecs_tpu/parallel/train.py``. The codec step:
reconstruction + commitment losses
through a straight-through RVQ, EMA codebooks with dead-code restarts, and
an optional multi-scale STFT term on a curriculum. The model is the port's
:class:`~audiocodecs_tpu_torch.models.encodec.Encodec` (its ``encoder``,
``decoder`` and ``codebooks``); the optimizer is a ``torch.optim``
optimizer over its parameters, updated in place.

On the card the encoder's and decoder's LSTMs and causal residual blocks
run the package's kernels in the forward; their backward recomputes
through the plain versions (:mod:`..ops._autograd`). The step runs its
forward and its backward with TF32 off (:func:`..nn.layers.exact_fp32`):
the switches are process-wide, so a ``backward()`` outside the ``with``
would run cuDNN's weight gradients in TF32.

Over a mesh (:mod:`.mesh`) the reference's GSPMD layouts become explicit
ones, each giving the unsharded numbers:

* :func:`shard_codec_params` stores each leaf that the reference shards on
  ``model`` (conv out-channels, LSTM gates, codebook vocab) as this rank's
  part; the step all-gathers the whole weights before the forward, so the
  kernels see whole weights, splits the batch on ``data``, averages the
  gradients over it and keeps this rank's part of each split leaf's
  (:class:`ShardedCodec`). The model axis thus saves no memory or compute:
  every model rank runs the whole forward and backward on the same rows;
* :func:`shard_llama_params` is Megatron's layout of the SLM decoder:
  q/k/v and gate/up split by column on head and FFN boundaries, o and down
  by row followed by an all-reduce, a vocab-parallel embedding and a
  column-split head whose logits are all-gathered before the CE
  (:class:`ShardedLlama`); :func:`make_slm_train_step` adds sequence
  parallelism on a ``seq`` axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from audiocodecs_tpu_torch.downstream.metrics.dsp import stft_mag
from audiocodecs_tpu_torch.nn.layers import Conv1d, ConvTranspose1d, exact_fp32
from audiocodecs_tpu_torch.parallel.comm import (
    all_gather_cat,
    all_reduce,
    copy_to,
    gather_shared,
    gather_split,
    reduce_from,
)
from audiocodecs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    shard_batch,
)
from audiocodecs_tpu_torch.quant.rvq import rvq_quantize, rvq_quantize_stats

__all__ = ["ShardedCodec", "ShardedLlama", "ShardedModule", "codec_loss",
           "init_codec_opt_state", "make_codec_train_step",
           "make_slm_train_step", "msstft_loss", "restart_rows",
           "shard_codec_params", "shard_llama_params", "slm_interleaved_ce"]

# the reference draws dead-code restarts from fold_in(PRNGKey(0x5EAC0DE), step)
DEAD_CODE_SEED = 0x5EAC0DE


def msstft_loss(rec: torch.Tensor, sig: torch.Tensor,
                fft_sizes=(256, 512, 1024)) -> torch.Tensor:
    """Multi-scale STFT loss: linear-magnitude L1 plus log-magnitude L1 at
    each FFT size (hop ``n_fft // 4``), averaged over the sizes."""
    total = 0.0
    for n_fft in fft_sizes:
        hop = n_fft // 4
        sh = stft_mag(rec, n_fft, hop)
        sr = stft_mag(sig, n_fft, hop)
        total = total + torch.mean(torch.abs(sh - sr)) + torch.mean(
            torch.abs(torch.log(sh + 1e-5) - torch.log(sr + 1e-5)))
    return total / len(fft_sizes)


def codec_loss(model, sig, num_codebooks: int, commit_weight=0.25,
               spec_weight=0.0, ema: bool = False):
    """VQ-VAE reconstruction + commitment (+ codebook) losses, plus the
    multi-scale STFT term when ``spec_weight`` may be nonzero.

    ``sig`` [B, T] (array or tensor; moved to the model's device and
    dtype: float32 on the card, any float type on the CPU). The RVQ
    argmax is straight-through; the reconstruction is trimmed to the shorter
    of input and output. With ``ema`` the codebooks enter detached, the
    codebook term is dropped and the aux carries the per-stage statistics
    ``(counts, sums, residuals)`` for :func:`make_codec_train_step`'s EMA
    update: returns ``(loss, (metrics, stats))``, else ``(loss, metrics)``.

    The spectral term is computed when ``spec_weight`` is a tensor (a
    curriculum weight, which may be 0 at this step but not at every step) or
    a nonzero number, as the reference gates it on a traced scalar."""
    sig = torch.as_tensor(sig, dtype=model.codebooks.dtype,
                          device=model.device)
    feats = model.encoder(sig[:, None, :]).transpose(1, 2)
    if ema:
        _, q, counts, sums, residuals = rvq_quantize_stats(
            feats, model.codebooks.detach(), num_codebooks)
    else:
        _, q = rvq_quantize(feats, model.codebooks, num_codebooks)
    q_st = feats + (q - feats).detach()
    rec = model.decoder(q_st.transpose(1, 2))[:, 0]
    T = min(rec.shape[1], sig.shape[1])
    recon = torch.mean((rec[:, :T] - sig[:, :T]) ** 2)
    commit = torch.mean((feats - q.detach()) ** 2)
    loss = recon + commit_weight * commit
    metrics = {"recon": recon, "commit": commit}
    if not ema:
        codebook = torch.mean((q - feats.detach()) ** 2)
        loss = loss + codebook
        metrics["codebook"] = codebook
    if isinstance(spec_weight, torch.Tensor) or spec_weight != 0:
        spec = msstft_loss(rec[:, :T], sig[:, :T])
        loss = loss + spec_weight * spec
        metrics["spec"] = spec
    if ema:
        return loss, (metrics, (counts, sums, residuals))
    return loss, metrics


def init_codec_opt_state(optimizer: torch.optim.Optimizer, model,
                         num_codebooks: int):
    """``(optimizer, qstate)`` for :func:`make_codec_train_step`'s EMA
    rule: ``optimizer`` (e.g. ``torch.optim.Adam(model.parameters(), lr)``)
    and the quantizer's EMA state on the model's device: per-code
    ``cluster_size`` [K, C] and ``embed_sum`` [K, C, H], zero, and
    ``steps``, the number of updates made (an int)."""
    cb = model.codebooks[:num_codebooks]
    qstate = {
        "cluster_size": torch.zeros(cb.shape[:2], dtype=cb.dtype,
                                    device=cb.device),
        "embed_sum": torch.zeros(cb.shape, dtype=cb.dtype, device=cb.device),
        "steps": 0,
    }
    return optimizer, qstate


def restart_rows(steps: int, num_codebooks: int, codebook_size: int,
                 n: int) -> torch.Tensor:
    """Rows of this batch's residuals ``[K, C]`` (int64, on the CPU) that
    replace dead codes at update ``steps``: a ``torch.Generator`` seeded
    from the reference's constant and the step, so that the card and the
    CPU draw the same rows (the draws differ from ``jax.random``'s)."""
    gen = torch.Generator().manual_seed((DEAD_CODE_SEED << 32) + steps)
    return torch.randint(0, n, (num_codebooks, codebook_size), generator=gen)


@torch.no_grad()
def _ema_codebook_update(model, qstate: dict, stats, num_codebooks: int,
                         decay: float, expire_threshold: float) -> None:
    """The EMA codebook rule with dead-code restarts, in place on
    ``model.codebooks[:K]`` and ``qstate``.

    On the first update the batch statistics are adopted outright (a
    data-dependent init); later ones decay toward them. Cluster means are
    Laplace-smoothed. Codes whose EMA cluster size is below
    ``expire_threshold`` restart from this batch's residuals at
    :func:`restart_rows`."""
    counts, sums, residuals = stats  # [K, C], [K, C, H], [K, B·N, H]
    K, C = num_codebooks, counts.shape[1]
    if qstate["steps"] == 0:
        cs, es = counts, sums
    else:
        cs = decay * qstate["cluster_size"] + (1.0 - decay) * counts
        es = decay * qstate["embed_sum"] + (1.0 - decay) * sums
    eps = 1e-5
    n = cs.sum(dim=-1, keepdim=True)
    smoothed = (cs + eps) / (n + C * eps) * n
    embed = es / smoothed[..., None]
    rows = restart_rows(qstate["steps"], K, C, residuals.shape[1])
    cand = torch.gather(residuals, 1, rows.to(residuals.device)[..., None]
                        .expand(-1, -1, residuals.shape[2]))
    dead = cs < expire_threshold
    embed = torch.where(dead[..., None], cand, embed)
    cs = torch.where(dead, torch.ones_like(cs), cs)
    es = torch.where(dead[..., None], cand, es)
    model.codebooks[:K] = embed
    qstate.update(cluster_size=cs, embed_sum=es, steps=qstate["steps"] + 1)


def make_codec_train_step(model, num_codebooks: int, spec_weight: float = 0.0,
                          ema_decay: float | None = 0.99,
                          expire_threshold: float = 1.0,
                          commit_weight: float = 0.25,
                          commit_warmup: int = 500, spec_delay: int = 0,
                          spec_ramp: int = 300):
    """The step ``(opt_state, sig) → metrics`` that trains ``model`` in
    place: zero the gradients, forward and backward with TF32 off, the
    optimizer's update, then (EMA rule) the codebook update.

    With ``ema_decay`` (the default) codebooks train by EMA statistics with
    dead-code restarts and ``opt_state`` is :func:`init_codec_opt_state`'s
    ``(optimizer, qstate)``; the commitment weight ramps in linearly over
    ``commit_warmup`` updates and the spectral weight over ``spec_ramp``
    updates after ``spec_delay`` (the reference's reasons are in its
    docstring). With ``ema_decay=None`` codebooks train by gradient,
    ``opt_state`` is the optimizer alone and both weights are fixed.

    ``metrics`` holds detached scalar tensors on the model's device:
    ``loss``, ``recon``, ``commit``, ``codebook`` (gradient rule), ``spec``
    (when computed) and ``codebook_util`` (EMA rule: the share of codes
    that won an assignment in this batch). The gradients stay in the
    parameters' ``.grad`` until the next step. The forward, the backward
    and the update run inside the profiler ranges ``codec_train_step.forward``,
    ``.backward`` and ``.update`` (free when no profiler records).

    ``model`` may be a :class:`ShardedCodec` (:func:`shard_codec_params`):
    ``sig`` is then the global batch, the same on every rank, whose rows
    must divide by the ``data`` axis; the optimizer is over the sharded
    leaves (``model.parameters()``); the metrics are the global batch's."""
    use_ema = ema_decay is not None
    sharded = isinstance(model, ShardedCodec)
    net = model.full if sharded else model

    def weights(steps: int):
        """(commit weight, spectral weight) at update ``steps``."""
        if not use_ema:
            return commit_weight, spec_weight
        cw = commit_weight * min(1.0, steps / max(commit_warmup, 1))
        if spec_weight <= 0:
            return cw, 0.0
        ramp = min(max((steps - spec_delay) / max(spec_ramp, 1), 0.0), 1.0)
        return cw, torch.tensor(spec_weight * ramp)

    def step(opt_state, sig):
        if use_ema:
            optimizer, qstate = opt_state
            cw, sw = weights(qstate["steps"])
        else:
            optimizer, (cw, sw) = opt_state, weights(0)
        optimizer.zero_grad(set_to_none=True)
        if sharded:
            sig = model.local_rows(sig)
            net.zero_grad(set_to_none=True)
            model.gather()
        with exact_fp32():
            with record_function("codec_train_step.forward"):
                loss, aux = codec_loss(net, sig, num_codebooks,
                                       commit_weight=cw, spec_weight=sw,
                                       ema=use_ema)
            with record_function("codec_train_step.backward"):
                loss.backward()
        metrics, stats = aux if use_ema else (aux, None)
        metrics["loss"] = loss
        with record_function("codec_train_step.update"):
            if sharded:
                model.reduce_grads()
                # recon, commit, spec are means over the rows: with equal
                # shards the mean of the ranks' means is the global mean
                metrics = model.batch_mean(metrics)
                if use_ema:
                    stats = model.reduce_stats(stats)
            optimizer.step()
            if use_ema:
                _ema_codebook_update(net, qstate, stats, num_codebooks,
                                     ema_decay, expire_threshold)
                if sharded:
                    model.store_codebooks()
                metrics["codebook_util"] = (stats[0] > 0).float().mean()
        return {k: v.detach() for k, v in metrics.items()}

    return step



# ----------------------------------------------------------------------- #
# Parameters on a mesh
# ----------------------------------------------------------------------- #


class ShardedModule(nn.Module):
    """A model's parameters on a mesh, as this rank holds them.

    ``split_axes`` maps a parameter's name to the axis along which it is
    split over ``model`` (each model rank holds a different part), and
    ``sum_over_model`` names the replicated ones whose gradient each model
    rank holds only a part of. The batch axes (every axis but ``model``)
    split the rows (``data``) or the tokens (``seq``); ``data_split`` is
    False when a batch could not be split and every data rank holds all of
    it. Subclasses say how the parameters make the reference's tree
    (:meth:`jax_tree`, :meth:`load_jax_tree`) and the whole model
    (:meth:`full_module`)."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.split_axes: dict = {}
        self.sum_over_model: set = set()
        self.data_split = True

    @property
    def model_group(self):
        return axis_group(self.mesh, MODEL_AXIS)

    def batch_axes(self) -> list:
        return [a for a in self.mesh.mesh_dim_names if a != MODEL_AXIS]

    def batch_mean(self, values):
        """Each value (a tensor or a dict of them, detached) averaged over
        the batch axes: the global value of per-rank shares."""
        if isinstance(values, dict):
            return {k: self.batch_mean(v) for k, v in values.items()}
        v = values.detach()
        for axis in self.batch_axes():
            v = all_reduce(v, axis_group(self.mesh, axis)) / axis_size(
                self.mesh, axis)
        return v

    def reduce_grads(self, grads: Optional[list] = None):
        """The gradients (``grads`` in ``named_parameters`` order, or each
        parameter's ``.grad`` in place when None) averaged over the batch
        axes, and summed over ``model`` where ``sum_over_model`` says."""
        named = list(self.named_parameters())
        own = grads is None
        grads = [p.grad for _, p in named] if own else list(grads)
        out = []
        for (name, _), g in zip(named, grads):
            if g is not None:
                g = self.batch_mean(g)
                if name in self.sum_over_model:
                    g = all_reduce(g, self.model_group)
            out.append(g)
        if own:
            for (_, p), g in zip(named, out):
                p.grad = g
        return out

    def sq_norm(self, grads: list) -> torch.Tensor:
        """The squared global norm of ``grads`` (``named_parameters``
        order): the split leaves' squares summed over ``model``, each
        replicated leaf counted once."""
        split = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        whole = torch.zeros_like(split)
        for (name, _), g in zip(self.named_parameters(), grads):
            sq = torch.sum(g.to(torch.float32) ** 2)
            if name in self.split_axes:
                split = split + sq
            else:
                whole = whole + sq
        return all_reduce(split, self.model_group) + whole

    def jax_tree(self):
        raise NotImplementedError

    def load_jax_tree(self, tree) -> None:
        raise NotImplementedError

    def full_module(self) -> nn.Module:
        raise NotImplementedError


def _part(t: torch.Tensor, axis: Optional[int], group) -> torch.Tensor:
    """This rank's part of ``t`` along ``axis`` split over ``group``."""
    if axis is None or group is None:
        return t
    return _own_chunk(t, group, axis)


def _own_chunk(t, group, axis):
    n, i = torch.distributed.get_world_size(group), \
        torch.distributed.get_rank(group)
    return t.chunk(n, dim=axis)[i].contiguous()


# ------------------------------- codec -------------------------------- #


def _leaf_spec(path: str, shape, mp: int) -> Optional[int]:
    """The axis of a codec leaf (in the reference's layout, ``shape``)
    that the reference shards on ``model``, or None for replicated: conv
    kernels ``[K, Cin, Cout]`` their out-channels, LSTM gate matrices
    ``[in, 4H]`` the 4H axis, codebooks ``[K, C, H]`` the vocab, a vector
    its only axis; any axis that does not divide by ``mp`` stays whole (the
    reference's ``_leaf_spec`` heuristic, rule for rule)."""
    ndim = len(shape)
    if ndim == 0 or mp == 1:
        return None
    if "codebooks" in path and ndim == 3 and shape[1] % mp == 0:
        return 1
    if ndim == 3 and shape[2] % mp == 0:
        return 2
    if ndim == 2 and shape[1] % mp == 0:
        return 1
    if ndim == 1 and shape[0] % mp == 0:
        return 0
    return None


def _port_axis(owner: nn.Module, leaf: str, shape) -> tuple:
    """(the leaf's shape in the reference's layout, reference axis → port
    axis) for a port parameter of ``shape``."""
    if leaf == "w" and isinstance(owner, ConvTranspose1d) \
            and owner.groups == 1:
        cin, cout, k = shape  # reference [K, Cin, Cout]
        return (k, cin, cout), {0: 2, 1: 0, 2: 1}
    if leaf == "w" and isinstance(owner, Conv1d):
        cout, cin, k = shape
        return (k, cin, cout), {0: 2, 1: 1, 2: 0}
    return tuple(shape), {a: a for a in range(len(shape))}


def _key(name: str) -> str:
    return name.replace(".", "__")


class ShardedCodec(ShardedModule):
    """A codec's parameters on a ``(data, model)`` mesh: each leaf that
    :func:`_leaf_spec` shards is stored as this rank's part along its
    model axis, the others whole. ``full`` is the working model (not a
    submodule: its parameters are not the optimizer's), into which
    :meth:`gather` all-gathers the whole weights before each forward."""

    def __init__(self, model: nn.Module, mesh):
        super().__init__(mesh)
        object.__setattr__(self, "full", model)
        mp = axis_size(mesh, MODEL_AXIS)
        self.shards = nn.ParameterDict()
        self.names = []
        for name, p in model.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name) if owner_name else model
            ref_shape, to_port = _port_axis(owner, leaf, p.shape)
            ref_axis = _leaf_spec(name.replace(".", "/"), ref_shape, mp)
            axis = None if ref_axis is None else to_port[ref_axis]
            if axis is not None:
                self.split_axes[f"shards.{_key(name)}"] = axis
            self.names.append(name)
            self.shards[_key(name)] = nn.Parameter(
                _part(p.detach(), axis, self.model_group).clone())

    def _axis(self, name: str):
        return self.split_axes.get(f"shards.{_key(name)}")

    @property
    def codebooks(self) -> torch.Tensor:
        return self.full.codebooks

    def local_rows(self, sig):
        """This rank's rows of the global batch ``sig`` on the device."""
        return shard_batch(self.mesh, sig, self.full.codebooks.device)

    @torch.no_grad()
    def gather(self) -> None:
        """Copy the whole weights into ``full`` (each split leaf
        all-gathered over ``model``, contiguous)."""
        group = self.model_group
        params = dict(self.full.named_parameters())
        for name in self.names:
            part = self.shards[_key(name)]
            axis = self._axis(name)
            whole = part if axis is None else all_gather_cat(part, group,
                                                             axis)
            params[name].copy_(whole)

    def reduce_grads(self, grads=None) -> None:
        """``full``'s gradients, averaged over ``data`` (equal shards of a
        global mean), as each shard's ``.grad``: a split leaf's all-reduced
        over ``model`` (every model rank computed it on the same rows),
        divided by the model degree and cut to this rank's part."""
        group, mp = self.model_group, axis_size(self.mesh, MODEL_AXIS)
        params = dict(self.full.named_parameters())
        for name in self.names:
            g = params[name].grad
            shard = self.shards[_key(name)]
            if g is None:
                shard.grad = None
                continue
            g = self.batch_mean(g)
            axis = self._axis(name)
            if axis is not None:
                g = _own_chunk(all_reduce(g, group) / mp, group, axis)
            shard.grad = g

    def reduce_stats(self, stats):
        """The EMA statistics of the global batch: counts and sums summed
        over ``data``; the residuals all-gathered in global row order (the
        dead-code restart draws rows of the global batch)."""
        counts, sums, residuals = stats
        group = axis_group(self.mesh, DATA_AXIS)
        return (all_reduce(counts, group), all_reduce(sums, group),
                all_gather_cat(residuals, group, 1))

    @torch.no_grad()
    def store_codebooks(self) -> None:
        """Copy ``full``'s codebooks (after the EMA update) into their
        shard."""
        self.shards[_key("codebooks")].copy_(_part(
            self.full.codebooks, self._axis("codebooks"), self.model_group))

    def full_module(self) -> nn.Module:
        """``full`` with the whole weights gathered into it."""
        self.gather()
        return self.full


def shard_codec_params(model: nn.Module, mesh) -> ShardedCodec:
    """The codec ``model`` on ``mesh`` with the reference's tensor-parallel
    shardings (:func:`_leaf_spec`) as :class:`ShardedCodec`; ``model``
    becomes its working copy."""
    return ShardedCodec(model, mesh)


# -------------------------------- SLM --------------------------------- #


def slm_interleaved_ce(logits, flat, mask, K: int, C: int):
    """The SLM objective: the K-interleaved next-token CE. Position i
    predicts i + 1 through the head of codebook ``i % K``; special targets
    (EOS, pad, text ids) map to the head's logits after the C content ones,
    clipped to the three specials' (``C + min(t − K·C, 2)``). ``logits``
    [B, L, K, C']; ``flat``/``mask`` [B, L]; the masked mean over the
    batch."""
    L = flat.shape[1]
    pos = torch.arange(L - 1, device=flat.device)
    lg = logits[:, pos, pos % K]  # [B, L-1, C']
    return _masked_ce(lg, flat[:, 1:], mask[:, 1:], K, C).sum() \
        / torch.clamp(mask[:, 1:].sum(), min=1.0)


def _masked_ce(lg, tgt, m, K: int, C: int):
    """Per-token CE of ``lg`` [B, T, C'] against flat targets, times the
    mask."""
    tgt = tgt.to(torch.int64)
    head_tgt = torch.where(tgt >= K * C,
                           C + torch.clamp(tgt - K * C, max=2), tgt)
    ce = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), head_tgt.reshape(-1),
                         reduction="none").reshape(head_tgt.shape)
    return ce * m


def _llama_axes(name: str, lcfg, mode: str, mp: int) -> tuple:
    """(split axis or None, summed over model) of a Llama parameter."""
    t = lcfg.transformer()
    leaf = name.split(".")
    if mode == "ep":
        if "moe" in leaf and leaf[-1] in ("w_in", "w_out"):
            return 0, False
        return None, "moe" in leaf and leaf[-1] == "router"
    if mp == 1 or mode != "tp":
        return None, False
    attn = t.num_kv_heads % mp == 0
    mlp = t.moe is None and t.intermediate_size % mp == 0
    if name == "embedding.table":
        return (0 if lcfg.flat_vocab % mp == 0 else None), False
    if name == "head.w":
        cols = lcfg.num_codebooks * lcfg.head_vocab
        return (1 if cols % mp == 0 else None), False
    if attn and leaf[-2] in ("q", "k", "v") and leaf[-1] == "w":
        return 1, False
    if attn and leaf[-2] == "o" and leaf[-1] == "w":
        return 0, False
    if mlp and leaf[-2] in ("gate", "up") and leaf[-1] == "w":
        return 1, False
    if mlp and leaf[-2] == "down" and leaf[-1] == "w":
        return 0, False
    return None, False


class ShardedLlama(ShardedModule):
    """The Llama decoder on a mesh, each rank holding its part (``local``,
    a :class:`...downstream.models.llama.Llama` whose split parameters are
    this rank's slices).

    ``mode="tp"`` is Megatron's layout (the reference's
    ``shard_llama_params``): when the KV heads divide by the model degree
    ``mp``, q/k/v are split by column on head boundaries (each rank holds
    ``num_kv_heads / mp`` KV heads and their query heads, so the GQA groups
    stay rank-local) and o by row, its output all-reduced; gate/up by
    column and down by row when the FFN divides; the embedding table by
    vocab row (masked lookup, all-reduced) and the head by column (logits
    all-gathered before the CE) when they divide. A block that does not
    divide is held whole and computed whole on every rank, as the
    reference's ``P()``; an MoE FFN is held whole. ``mode="ep"`` is expert
    parallelism (:func:`..moe.shard_moe_llama_params`): each layer's
    experts split on ``model``, all else whole.

    An MoE FFN routes over the global batch (capacity and queue order
    counting every data rank's tokens), as GSPMD keeps the unsharded
    program's routing."""

    def __init__(self, model, mesh, mode: str = "tp"):
        super().__init__(mesh)
        from audiocodecs_tpu_torch.downstream.models.llama import Llama

        if mode not in ("tp", "ep"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg, self.mode = model.cfg, mode
        t = self.cfg.transformer()
        mp = axis_size(mesh, MODEL_AXIS)
        if mode == "ep":
            if t.moe is None:
                raise ValueError("expert parallelism needs moe_experts > 0")
            if t.moe.num_experts % mp:
                raise ValueError(f"{t.moe.num_experts} experts not "
                                 f"divisible by {MODEL_AXIS}={mp}")
        if any(p.b is not None for layer in model.body.layers
               for p in (layer.q, layer.k, layer.v, layer.o)):
            raise ValueError("a row-split projection cannot carry a bias")
        with torch.device("meta"):
            self.local = Llama(self.cfg)
        group = self.model_group
        for name, p in model.named_parameters():
            axis, summed = _llama_axes(name, self.cfg, mode, mp)
            owner_name, _, leaf = name.rpartition(".")
            owner = self.local.get_submodule(owner_name)
            setattr(owner, leaf, nn.Parameter(
                _part(p.detach(), axis, group).clone()))
            if axis is not None:
                self.split_axes["local." + name] = axis
            if summed:
                self.sum_over_model.add("local." + name)
        split = self.split_axes
        self.attn_split = "local.body.layers.0.q.w" in split \
            and mode == "tp"
        self.mlp_split = "local.body.layers.0.mlp.gate.w" in split
        self.table_split = "local.embedding.table" in split
        self.head_split = "local.head.w" in split

    # -------------------------- the forward -------------------------- #

    def _embed(self, flat, off: int):
        from audiocodecs_tpu_torch.downstream.models.llama import embed_rows

        idx = embed_rows(flat, self.cfg, off)
        table = self.local.embedding.table
        if not self.table_split:
            return table[idx]
        rows = table.shape[0]
        local = idx - rows * axis_index(self.mesh, MODEL_AXIS)
        ok = (local >= 0) & (local < rows)
        e = table[torch.clamp(local, 0, rows - 1)] * ok[..., None].to(
            table.dtype)
        return reduce_from(e, self.model_group)

    def _layer(self, x, p, cos, sin, mask, seq_group, data_group):
        from audiocodecs_tpu_torch.nn.transformer import (
            _linear, _mlp, _norm, apply_rope, attention)
        from audiocodecs_tpu_torch.parallel.moe import moe_ffn

        t = self.cfg.transformer()
        mg = self.model_group
        B, T, H = x.shape
        mp = axis_size(self.mesh, MODEL_AXIS) if self.attn_split else 1
        hq, hkv = t.num_heads // mp, t.num_kv_heads // mp
        h = _norm(x, p.ln1, t.norm, t.norm_eps)
        if self.attn_split:
            h = copy_to(h, mg)
        q = _linear(h, p.q).reshape(B, T, hq, t.head_dim)
        k = _linear(h, p.k).reshape(B, T, hkv, t.head_dim)
        v = _linear(h, p.v).reshape(B, T, hkv, t.head_dim)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k, v = gather_shared(k, seq_group, 1), gather_shared(v, seq_group, 1)
        a = _linear(attention(q, k, v, mask).reshape(B, T, hq * t.head_dim),
                    p.o)
        if self.attn_split:
            a = reduce_from(a, mg)
        x = x + a
        h = _norm(x, p.ln2, t.norm, t.norm_eps)
        if t.moe is not None:
            m, aux = moe_ffn(p.moe.params(), h.reshape(B * T, H), t.moe,
                             data_group, mg if self.mode == "ep" else None)
            m = m.reshape(B, T, H)
        elif self.mlp_split:
            m = reduce_from(_mlp(copy_to(h, mg), p.mlp, t.act), mg)
            aux = x.new_zeros(())
        else:
            m, aux = _mlp(h, p.mlp, t.act), x.new_zeros(())
        return x + m, aux

    def logits(self, flat, sequence_axis: Optional[str] = None):
        """Logits ``[B, Ls, K, C']`` of this rank's tokens (all of
        ``flat``'s, or its ``Ls = L / S`` at the rank's offset on
        ``sequence_axis``), with the MoE aux share and the offset."""
        from audiocodecs_tpu_torch.nn.transformer import (
            _norm, remat_layer, rope_cos_sin)

        t = self.cfg.transformer()
        seq_group = (axis_group(self.mesh, sequence_axis)
                     if sequence_axis else None)
        S = axis_size(self.mesh, sequence_axis) if sequence_axis else 1
        L = flat.shape[1]
        if L % S:
            raise ValueError(f"{L} tokens do not divide by the "
                             f"{sequence_axis} axis of {S}")
        if S > 1 and t.moe is not None:
            raise ValueError("sequence parallelism with an MoE FFN is not "
                             "supported")
        Ls = L // S
        off = Ls * (axis_index(self.mesh, sequence_axis) if sequence_axis
                    else 0)
        data_group = (axis_group(self.mesh, DATA_AXIS) if self.data_split
                      else None)
        x = self._embed(flat[:, off:off + Ls], off)
        pos = off + torch.arange(Ls, device=flat.device)
        cos, sin = rope_cos_sin(pos, t.head_dim, t.rope_theta)
        zero = torch.zeros((), dtype=torch.float32, device=flat.device)
        mask = torch.where(torch.arange(L, device=flat.device)[None, :]
                           <= pos[:, None], zero, float("-inf"))
        mask = mask[None, None, None]
        aux = x.new_zeros(())
        for p in self.local.body.layers:
            args = (x, p, cos, sin, mask, seq_group, data_group)
            x, a = (remat_layer(self._layer, *args) if t.remat
                    else self._layer(*args))
            aux = aux + a
        x = _norm(x, self.local.body.final_norm, t.norm, t.norm_eps)
        if self.head_split:
            x = copy_to(x, self.model_group)
        with exact_fp32():
            lg = torch.matmul(x, self.local.head.w)
        if self.head_split:
            lg = gather_split(lg, self.model_group, -1)
        B = flat.shape[0]
        return lg.reshape(B, Ls, self.cfg.num_codebooks, -1), aux, off

    def nll(self, flat, mask, with_aux: bool = False,
            sequence_axis: Optional[str] = None):
        """This rank's share of the global masked next-token CE (plus the
        weighted MoE aux with ``with_aux``): its masked sum over the global
        mask count, scaled so that the mean of the shares over the batch
        axes is the global loss. ``flat``/``mask`` are this rank's rows
        (all of them when ``data_split`` is False), every token of them."""
        K, C = self.cfg.num_codebooks, self.cfg.vocab_size
        logits, aux, off = self.logits(flat, sequence_axis)
        L, Ls = flat.shape[1], logits.shape[1]
        pos = off + torch.arange(Ls, device=flat.device)
        keep = pos < L - 1
        pos, nxt = pos[keep], pos[keep] + 1
        lg = logits[:, keep][:, torch.arange(len(pos)), pos % K]
        local = _masked_ce(lg, flat[:, nxt], mask[:, nxt], K, C).sum()
        # every seq rank holds its rows' whole mask: count over data only
        count, ranks = mask[:, 1:].sum(), 1
        if self.data_split:
            count = all_reduce(count, axis_group(self.mesh, DATA_AXIS))
            ranks = axis_size(self.mesh, DATA_AXIS)
        if sequence_axis:
            ranks *= axis_size(self.mesh, sequence_axis)
        loss = local / torch.clamp(count, min=1.0) * ranks
        if with_aux and self.cfg.moe_experts > 0 \
                and self.cfg.moe_aux_weight > 0:
            d = axis_size(self.mesh, DATA_AXIS) if self.data_split else 1
            loss = loss + self.cfg.moe_aux_weight * aux * d
        return loss

    # -------------------------- whole trees -------------------------- #

    def _full_state(self) -> dict:
        group = self.model_group
        out = {}
        for name, p in self.named_parameters():
            axis = self.split_axes.get(name)
            whole = p.detach() if axis is None else all_gather_cat(
                p.detach(), group, axis)
            out[name[len("local."):]] = whole
        return out

    def _template(self):
        from audiocodecs_tpu_torch.downstream.models.llama import Llama

        with torch.device("meta"):
            return Llama(self.cfg)

    def jax_tree(self):
        from audiocodecs_tpu_torch.params import to_jax_params

        return to_jax_params(self._full_state(), self._template())

    @torch.no_grad()
    def load_jax_tree(self, tree) -> None:
        from audiocodecs_tpu_torch.params import from_jax_params

        sd = from_jax_params(tree, self._template())
        for name, p in self.named_parameters():
            p.copy_(_part(sd[name[len("local."):]].to(p.device),
                          self.split_axes.get(name), self.model_group))

    def full_module(self):
        """The whole decoder on every rank (the one-device module)."""
        from audiocodecs_tpu_torch.downstream.models.llama import Llama

        state = self._full_state()
        model = Llama(self.cfg)
        model.load_state_dict({k: v.cpu() for k, v in state.items()},
                              strict=True)
        return model.to(next(self.parameters()).device)


def shard_llama_params(model, mesh) -> ShardedLlama:
    """Megatron-style tensor parallelism of the Llama decoder ``model``
    on ``mesh``'s ``model`` axis (:class:`ShardedLlama`, ``mode="tp"``)."""
    return ShardedLlama(model, mesh, mode="tp")


def make_slm_train_step(model, optimizer: torch.optim.Optimizer,
                        sequence_axis: Optional[str] = None):
    """The SLM training step ``(flat, mask) → loss``: the K-interleaved
    next-token CE of the Llama decoder (:func:`slm_interleaved_ce`), its
    gradient and ``optimizer``'s update, in place.

    ``model`` is a one-device ``Llama`` or a :class:`ShardedLlama`
    (``optimizer`` over its ``parameters()``). Sharded, ``flat``/``mask``
    [B, L] are the global batch, the same on every rank; its rows are
    split on ``data`` (they must divide) and, with ``sequence_axis``, its
    tokens on that mesh axis: each rank's queries attend to the
    all-gathered keys and values under the causal mask, RoPE at its tokens'
    absolute positions, and the CE is a global masked sum over the global
    count. The returned loss is the global batch's."""
    from audiocodecs_tpu_torch.downstream.models.llama import (
        llama_embed, llama_forward)

    def step(flat, mask):
        optimizer.zero_grad(set_to_none=True)
        if isinstance(model, ShardedLlama):
            dev = next(model.parameters()).device
            flat, mask = shard_batch(model.mesh, (flat, mask), dev)
            model.data_split = True
            loss = model.nll(flat, mask, sequence_axis=sequence_axis)
            loss.backward()
            model.reduce_grads()
            value = model.batch_mean(loss)
        else:
            cfg = model.cfg
            logits = llama_forward(model, llama_embed(model, flat, cfg), cfg)
            loss = slm_interleaved_ce(logits, flat, mask,
                                      cfg.num_codebooks, cfg.vocab_size)
            loss.backward()
            value = loss.detach()
        optimizer.step()
        return value

    return step
