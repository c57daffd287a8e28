"""Collectives of the parallel layer, with the gradients each layout needs.

GSPMD derives these in the reference; the port writes them out. Each takes
a process group, or None for a line of one rank, where it is the identity
and launches nothing. Every tensor handed to a collective is made
contiguous first (gloo and NCCL refuse strided buffers, and the kernel
wrappers refuse them on the card).

* :func:`copy_to` and :func:`reduce_from` are Megatron's ``f`` and ``g``:
  a replicated activation enters a split layer through ``copy_to``
  (identity forward, all-reduced gradient) and a row-split product leaves
  through ``reduce_from`` (all-reduced forward, identity gradient), so the
  loss computed alike on every rank of the line is counted once.
* :func:`gather_split` all-gathers a split output (a column-split head's
  logits) for a loss computed alike on every rank: its gradient is this
  rank's part of the incoming one.
* :func:`gather_shared` all-gathers what every rank's own share of the loss
  reads (sequence parallelism's keys and values): its gradient sums the
  ranks' parts.
* :func:`scale_grad` keeps a term that every rank of a line computes alike
  from being counted once a rank when its gradient is summed over the line.
* :func:`ring_permute` is ``lax.ppermute`` over a ring: rank i sends to
  i + 1 and receives from i − 1; its gradient goes the other way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_cat", "all_reduce", "copy_to", "gather_shared",
           "gather_split", "reduce_from", "ring_permute", "scale_grad"]


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A summed (or ``op``) copy of ``t`` over ``group``; ``t`` itself when
    the group is None."""
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of ``group`` concatenated on ``dim`` in rank order
    (contiguous); ``t`` itself when the group is None."""
    if group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _own(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = _size(group), dist.get_rank(group)
    return t.chunk(n, dim=dim)[i].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim), None, None


class _GatherShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(all_reduce(g.contiguous(), ctx.group), ctx.group,
                    ctx.dim), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _permute(x: torch.Tensor, ranks: list, shift: int) -> torch.Tensor:
    me = dist.get_rank()
    i = ranks.index(me)
    out = torch.empty_like(x)
    x = x.contiguous()
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % len(ranks)]),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % len(ranks)])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return _permute(x.detach(), ranks, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.ranks, -1), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` unchanged; its gradient summed over
    ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``group``; its gradient
    unchanged."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim``, for a loss every rank
    computes alike: the gradient is this rank's part."""
    return x if group is None else _GatherSplit.apply(x, group, dim)


def gather_shared(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim``, read by each rank's own
    share of the loss: the gradient sums every rank's part."""
    return x if group is None else _GatherShared.apply(x, group, dim)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` unchanged; its gradient times ``scale``."""
    return x if scale == 1 else _ScaleGrad.apply(x, scale)


def ring_permute(x: torch.Tensor, ranks: list) -> torch.Tensor:
    """``x`` sent to the next rank of ``ranks`` (a ring, in order) and the
    previous rank's received; the gradient travels back. The identity on a
    ring of one."""
    return x if len(ranks) == 1 else _RingPermute.apply(x, ranks)
