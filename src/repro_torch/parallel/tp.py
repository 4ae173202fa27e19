"""Collectives over the tensor-parallel (model) group that carry their
gradients, each a `torch.autograd.Function` written against
`torch.distributed` (not `torch.distributed.nn.functional`, whose
backward conventions differ):

  * `copy_to`: identity forward, all-reduce backward (Megatron's f);
  * `reduce_from`: all-reduce forward, identity backward (Megatron's g);
  * `gather`: all-gather along a dim forward, reduce-scatter backward;
  * `reduce_scatter`: reduce-scatter along a dim forward, all-gather
    backward;
  * `all_to_all`: `all_to_all_single` forward (chunk j of dim 0 to rank
    j), the same exchange of the gradients backward.

The model keeps the gradient of a replicated activation partial: each
rank holds its own terms and their sum over the group is the gradient.
Every replicated leaf then has a partial gradient, whatever the layout
of the residual stream, and one sum over the group after autograd
finishes them all (`train.loop.make_grad_fn`, which seeds the
replicated loss with 1 / tp).  A sum of the ranks' terms into a
replicated value is therefore `reduce`: g, then f, one all-reduce each
way.  A slice of a replicated value needs no collective (autograd's
narrow pads the gradient with zeros).

Every collective runs on the group it is given, also at one rank, where
it is a copy; none is caught.  Results come back contiguous in their
input's dim order, so that what follows sums in the order it would on
one rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {tuple(x.shape)} along dim "
                         f"{dim} over {n} ranks: the dim does not divide")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient summed over the group."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group; the gradient passed as it is."""
    return _ReduceFrom.apply(x, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' terms x into a replicated value whose
    gradient is partial (module docstring): `reduce_from`, then
    `copy_to`."""
    return copy_to(reduce_from(x, group), group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' slices x concatenated along `dim` in rank order."""
    return _Gather.apply(x, dim % x.ndim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of x over the group."""
    return _ReduceScatter.apply(x, dim % x.ndim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's dim 0 sent to rank j; chunk i of the result is what
    rank i sent here."""
    return _AllToAll.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the group (`reduce` over the group's size)."""
    return reduce(x, group) / dist.get_world_size(group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of x over the group, outside autograd."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)
