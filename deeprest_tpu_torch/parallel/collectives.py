"""The collectives GSPMD inserts for the expert and model axes, written out
as autograd operators with explicit backwards.

JAX places the params by the rule table (``parallel/sharding.py``) and
the partitioner inserts the cross-rank sums.  The port's ranks hold their
boxes and call these operators where those sums fall; each names its
forward and its backward, because which backward is right depends on
whether what runs downstream is replicated over the group (every rank
computes the whole of it) or partial (each rank a share):

- :func:`sum_partials`: SUM all-reduce forward, SUM all-reduce backward.
  The downstream is partial: the cross-expert mixing total (each expert
  rank uses it for its own experts) and the soft mask's softmax
  denominator (each model rank's mask shard feeds its own part of the
  projection).
- :func:`reduce_replicated` (Megatron's "g"): SUM all-reduce forward,
  identity backward.  The downstream is replicated: the layer-0 input
  projection summed over the model group's F shards.
- :func:`copy_replicated` (Megatron's "f"): identity forward, SUM
  all-reduce backward.  A replicated value each rank feeds into its own
  shard: the mask MLP's hidden layer before the ``mask_w2`` shard, so the
  ``mask_w1``/``mask_b1`` gradients come out whole on every model rank.
- :func:`gather_along`: all-gather along a dimension forward, the rank's
  slice of the gradient backward (a rank's experts' answers gathered into
  ``[..., E, Q]``).
- :func:`max_replicated`: a MAX all-reduce outside autograd (the
  softmax's shift, which changes no value and takes no gradient).

A ``group`` of None is an axis of one rank: every operator is then the
identity.  Every collective is an ordinary ``torch.distributed`` call on
the caller's stream with no host sync, so under NCCL it captures inside a
CUDA graph with the update or rung that calls it; gloo's cannot be
captured, and its callers run eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        ctx.dim, ctx.index, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
                .contiguous(), None, None)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group`` whose downstream is partial: SUM backward."""
    return x if group is None else _SumPartials.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group`` whose downstream is replicated: identity
    backward ("g")."""
    return x if group is None else _ReduceReplicated.apply(x, group)


def copy_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, SUM backward over ``group`` ("f")."""
    return x if group is None else _CopyReplicated.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in group
    rank order; the backward keeps this rank's slice."""
    return x if group is None else _GatherAlong.apply(x, dim % x.dim(), group)


def max_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise MAX over ``group``, detached (no gradient)."""
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


__all__ = [
    "copy_replicated",
    "gather_along",
    "max_replicated",
    "reduce_replicated",
    "sum_partials",
]
