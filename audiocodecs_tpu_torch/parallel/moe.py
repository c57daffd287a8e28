"""Expert parallelism: the switch-MoE FFN over a mesh.

Counterpart of ``audiocodecs_tpu/parallel/moe.py``. A token-routed FFN with
capacity-bounded one-hot dispatch, written as products (dispatch and
combine are einsums over one-hot masks, no scatter):

* experts are stacked ``[E, ...]``; under expert parallelism each rank of
  the ``model`` axis holds ``E/S`` of them, computes the (cheap) routing of
  its tokens, applies only its own experts, and the combine is summed over
  ``model`` (:func:`..comm.reduce_from`);
* switch top-1 gates with the raw router probability; ``top_k >= 2`` is
  GShard's rule, gates renormalised over the chosen experts and rank-r
  assignments queued behind every rank < r for capacity
  ``max(1, int(cf · N / E))``; overflow tokens are dropped (the residual
  path keeps them);
* the load-balancing loss is Switch's ``E · Σ_e f_e · P_e``.

:func:`make_moe_train_step` routes each data shard on its own, as the
reference's shard_map step does. Inside the Llama decoder
(:func:`shard_moe_llama_params`) the routing spans the global batch, as
GSPMD keeps the unsharded program's: queue positions are offset by the
counts of the data ranks before this one and the capacity counts every
token.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from audiocodecs_tpu_torch.nn.layers import exact_fp32
from audiocodecs_tpu_torch.parallel.comm import (
    all_gather_cat,
    all_reduce,
    copy_to,
    reduce_from,
    scale_grad,
)
from audiocodecs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    shard_batch,
)

__all__ = ["MoE", "MoEConfig", "init_moe_params", "make_moe_train_step",
           "moe_ffn", "moe_ffn_dense", "moe_ffn_dense_aux",
           "shard_moe_llama_params", "shard_moe_params"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int = 64
    ffn_size: int = 128
    num_experts: int = 4
    capacity_factor: float = 2.0
    # 1 = switch (gate = raw top probability); k >= 2 = GShard top-k
    top_k: int = 1
    # Switch load-balancing loss weight (0 keeps it out of training)
    aux_weight: float = 0.0

    def capacity(self, tokens: int) -> int:
        return max(1, int(self.capacity_factor * tokens / self.num_experts))


class MoE(nn.Module):
    """``router`` [D, E], ``w_in`` [E, D, F], ``w_out`` [E, F, D]: the
    reference's leaves, key for key (a layer's ``moe``)."""

    def __init__(self, cfg: MoEConfig):
        super().__init__()
        D, Fd, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
        self.router = nn.Parameter(torch.empty(D, E))
        self.w_in = nn.Parameter(torch.empty(E, D, Fd))
        self.w_out = nn.Parameter(torch.empty(E, Fd, D))

    def params(self) -> dict:
        return {"router": self.router, "w_in": self.w_in,
                "w_out": self.w_out}


def init_moe_params(generator: torch.Generator, cfg: MoEConfig) -> dict:
    """``{"router", "w_in", "w_out"}`` in the reference's distributions
    (N(0, 1/D), N(0, 1/D), N(0, 1/F)); the draws differ from
    ``jax.random``'s."""
    D, Fd, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    return {
        "router": torch.randn(D, E, generator=generator) * D ** -0.5,
        "w_in": torch.randn(E, D, Fd, generator=generator) * D ** -0.5,
        "w_out": torch.randn(E, Fd, D, generator=generator) * Fd ** -0.5,
    }


def _route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig,
           data_group=None):
    """``x`` [N, D] → (dispatch [N, E, C], combine [N, E, C], aux).

    With ``data_group`` the N rows are this rank's part of a global batch
    split over the group in rank order: capacity counts every token, queue
    positions follow the global token order, and ``aux`` is this rank's
    share of the global loss (the shares sum to it)."""
    N, E = x.shape[0], cfg.num_experts
    ranks = 1 if data_group is None else torch.distributed.get_world_size(
        data_group)
    C = cfg.capacity(N * ranks)
    with exact_fp32():
        probs = torch.softmax(torch.matmul(x, router), dim=-1)  # [N, E]
    k = cfg.top_k
    top_gates, top_experts = torch.topk(probs, k, dim=-1)  # [N, k]
    if k > 1:
        top_gates = top_gates / torch.clamp(
            top_gates.sum(-1, keepdim=True), min=1e-9)
    onehots = F.one_hot(top_experts, E).to(x.dtype)  # [N, k, E]
    mine = onehots.sum(0)  # [k, E] assignments of this rank's tokens
    if data_group is None:
        before, total = torch.zeros_like(mine), mine
    else:
        every = all_gather_cat(mine[None], data_group, 0)  # [R, k, E]
        before = every[:torch.distributed.get_rank(data_group)].sum(0)
        total = every.sum(0)
    dispatch = x.new_zeros(N, E, C)
    combine = x.new_zeros(N, E, C)
    counts = x.new_zeros(E)  # queue fill of the ranks < r
    for r in range(k):
        oh = onehots[:, r, :]
        pos = (torch.cumsum(oh, dim=0) - 1.0 + before[r]) * oh \
            + counts[None] * oh
        oh = oh * (pos < C)
        pos_oh = F.one_hot((pos * oh).sum(-1).to(torch.int64), C).to(x.dtype)
        d = oh[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * top_gates[:, r][:, None, None]
        counts = counts + total[r]
    n_all = N * ranks
    frac = total[0] / n_all  # primary-assignment fraction [E]
    aux = E * torch.sum(frac * probs.sum(0) / n_all)
    return dispatch, combine, aux


def _expert_ffn(w_in, w_out, h):
    """h [E', C, D] → [E', C, D] through each expert's GELU MLP."""
    with exact_fp32():
        u = F.gelu(torch.einsum("ecd,edf->ecf", h, w_in))
        return torch.einsum("ecf,efd->ecd", u, w_out)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, data_group=None,
            model_group=None):
    """``x`` [N, D] → ([N, D], aux) through ``params`` (``router``, and
    ``w_in``/``w_out`` of this rank's experts: all of them without
    ``model_group``, else the rank's ``E/S``, the combine summed over the
    group). ``data_group``: route over the global batch (:func:`_route`).
    Every rank of ``model_group`` computes the same ``aux``; its gradient
    is scaled by 1/S so the sum over the group counts it once."""
    x = copy_to(x, model_group)
    dispatch, combine, aux = _route(params["router"], x, cfg, data_group)
    e = params["w_in"].shape[0]
    lo = 0 if model_group is None else e * torch.distributed.get_rank(
        model_group)
    with exact_fp32():
        h = torch.einsum("nec,nd->ecd", dispatch[:, lo:lo + e], x)
    h = _expert_ffn(params["w_in"], params["w_out"], h)
    with exact_fp32():
        out = torch.einsum("nec,ecd->nd", combine[:, lo:lo + e], h)
    if model_group is not None:
        out = reduce_from(out, model_group)
        aux = scale_grad(aux, 1.0 / torch.distributed.get_world_size(
            model_group))
    return out, aux


def moe_ffn_dense_aux(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """Every expert on this rank: ``x`` [N, D] → ([N, D], aux); the
    residual is the caller's, ``aux`` the load-balancing loss (weight it
    with ``cfg.aux_weight``)."""
    return moe_ffn(params, x, cfg)


def moe_ffn_dense(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """:func:`moe_ffn_dense_aux` without the aux."""
    return moe_ffn(params, x, cfg)[0]


def _local_experts(t: torch.Tensor, mesh) -> torch.Tensor:
    S, i = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    if t.shape[0] % S:
        raise ValueError(f"{t.shape[0]} experts not divisible by "
                         f"{MODEL_AXIS}={S}")
    e = t.shape[0] // S
    return t[i * e:(i + 1) * e].contiguous()


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's leaves: its ``E/S`` experts of ``w_in``/``w_out`` on
    ``model`` and the whole router, as trainable leaf tensors."""
    return {name: (_local_experts(t.detach(), mesh)
                   if name in ("w_in", "w_out") else t.detach().clone())
            .requires_grad_() for name, t in params.items()}


def shard_moe_llama_params(model, mesh):
    """Expert-parallel placement of an MoE Llama decoder (``LlamaConfig.
    moe_experts > 0``): every layer's stacked experts split on the
    ``model`` axis, the routers, attention, embedding and head whole on
    every rank (:class:`..parallel.train.ShardedLlama` in its ``"ep"``
    mode)."""
    from audiocodecs_tpu_torch.parallel.train import ShardedLlama

    return ShardedLlama(model, mesh, mode="ep")


def make_moe_train_step(cfg: MoEConfig, mesh):
    """The expert-parallel step on a toy regression loss: ``(step,
    loss_fn, forward)``.

    ``forward(params, x)``: this rank's rows of ``x`` routed on their own
    (each data shard routes alone, so capacity drops depend on the data
    degree, as in the reference), its experts applied, the combine summed
    over ``model``. ``loss_fn(params, x, y)``: the mean of ``(x + forward -
    y)²`` over this rank's rows. ``step(params, optimizer, x, y)`` takes the
    global batch, updates ``params`` (:func:`shard_moe_params`) in place
    through ``optimizer`` and returns the global loss: gradients averaged
    over ``data``, and the replicated router's summed over ``model`` once,
    since each rank's holds only its own experts' part."""
    S = axis_size(mesh, MODEL_AXIS)
    if cfg.num_experts % S:
        raise ValueError(f"{cfg.num_experts} experts not divisible by "
                         f"{MODEL_AXIS}={S}")
    model_group = axis_group(mesh, MODEL_AXIS)
    data_group, D = axis_group(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)

    def forward(params, x):
        return moe_ffn(params, x, cfg, model_group=model_group)[0]

    def loss_fn(params, x, y):
        return torch.mean((x + forward(params, x) - y) ** 2)

    def step(params, optimizer, x, y):
        x, y = shard_batch(mesh, (x, y), params["router"].device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, x, y)
        loss.backward()
        for name, p in params.items():
            g = all_reduce(p.grad, data_group) / D
            if name == "router":
                g = all_reduce(g, model_group)
            p.grad = g
        optimizer.step()
        return all_reduce(loss.detach(), data_group) / D

    return step, loss_fn, forward
