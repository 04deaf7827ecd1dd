"""Collectives with the backward that graph-sharded training needs
(the XLA collectives ``jax.lax.psum`` and ``all_gather`` of
gcnbmp_tpu/parallel/edgeshard.py under ``jax.grad``).

Every rank computes its own part L_r of the objective L = sum_r L_r and
calls backward on it:

- ``all_reduce_sum(x)``: y = sum_r x_r, the same on every rank, read by
  each rank's own L_r; so dL/dx_r = sum_r' dL_r'/dy, and the backward
  sums the incoming gradients over the ranks.
- ``all_gather_tiled(x)``: the ranks' blocks concatenated in rank order
  along dim 0; its backward sums the incoming gradients over the ranks
  and keeps this rank's block (a reduce-scatter, taken as an all-reduce
  and a slice, which every backend carries).
- ``all_reduce_sum_list(tensors)``: a list of tensors summed over the
  ranks as one flat buffer, without autograd (the parameter gradients).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGatherTiled(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        ctx.rows = x.shape[0]
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """sum_r x_r on every rank; the backward sums the gradients too."""
    return _AllReduceSum.apply(x, group)


def all_gather_tiled(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' (n, ...) blocks as one (ranks * n, ...) tensor in rank
    order; the backward returns this rank's block of the summed
    gradients."""
    return _AllGatherTiled.apply(x, group)


def all_gather_tensor(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather_tiled`` without autograd (index tensors)."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce_sum_list(tensors: Sequence[torch.Tensor],
                        group=None) -> List[torch.Tensor]:
    """``tensors`` summed over the ranks, without autograd, through one
    flat buffer (one collective): views of the summed buffer, in order
    and in the tensors' shapes (the parameter gradients)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]
