"""Data parallelism plus tensor parallelism for the padded pair predictor
over a (data, model) mesh (port of gcnbmp_tpu/parallel/dp.py:24-91).

The batch is split over ``data``.  The GGNN message linears (H -> 4H) and
every Dense kernel at least 256 wide have their output columns split over
``model`` (``shard_params``); their biases and every other parameter are
replicated, as the JAX ``PartitionSpec``s place them.  A split linear
computes its own columns and gathers the rest from the model group
(``collectives.all_gather_tiled``).  No kernel runs here, in either
package.

Gradients: every rank of a data group computes the same replicated
activations, and so the same loss, so each rank back-propagates that
loss divided by the model size; the all-gather's backward then sums the
model group's shares into each split weight's gradient.  Split weights
sum their gradients over the data axis, replicated parameters over
every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from gcnbmp_tpu_torch.parallel.collectives import (
    all_gather_tiled, all_reduce_sum_list)
from gcnbmp_tpu_torch.train.loop import sigmoid_ce_elements


class ColumnShardedLinear(nn.Module):
    """An ``nn.Linear`` holding the block of output columns of one rank of
    the model group; the output is the full width, gathered."""

    def __init__(self, linear: nn.Linear, group, rank: int, size: int):
        super().__init__()
        per = linear.out_features // size
        self.group = group
        self.weight = nn.Parameter(
            linear.weight.detach()[rank * per:(rank + 1) * per].clone())
        self.bias = linear.bias

    def forward(self, x):
        y = torch.nn.functional.linear(x, self.weight)
        y = all_gather_tiled(y.movedim(-1, 0).contiguous(),
                             self.group).movedim(0, -1)
        return y if self.bias is None else y + self.bias


def _split(name: str, linear: nn.Linear) -> bool:
    """The JAX rule (dp.py:24-38): the message linear, or any Dense
    kernel with an output at least 256 wide."""
    return "message" in name.split(".") or linear.out_features >= 256


def shard_params(predictor: nn.Module, mesh) -> nn.Module:
    """Split, in place, the output columns of ``predictor``'s message
    linears and wide Dense kernels over ``mesh``'s ``model`` axis, where
    the width divides evenly (the rest stay replicated).  A mesh whose
    model axis has one rank splits nothing.  Returns ``predictor``."""
    size = mesh["model"].size()
    if size == 1:
        return predictor
    group, rank = mesh.get_group("model"), mesh.get_local_rank("model")
    for name, module in list(predictor.named_modules()):
        if isinstance(module, nn.Linear) and _split(name, module) \
                and module.out_features % size == 0:
            parent_name, _, child = name.rpartition(".")
            parent = predictor.get_submodule(parent_name)
            setattr(parent, child, ColumnShardedLinear(module, group, rank,
                                                       size))
    return predictor


def make_sharded_train_step(predictor: nn.Module, optimizer, mesh,
                            class_num: int = 1) -> Callable:
    """``step(atoms1, adj1, atoms2, adj2, mask1, mask2, labels) -> loss``
    over a global padded batch: this rank runs its ``data`` block through
    ``predictor`` (after ``shard_params``; ``deterministic=False``), the
    loss is the sigmoid cross-entropy's mean over the whole batch, and
    ``optimizer`` (a ``train.loop.ChainedAdam`` over
    ``predictor.parameters()``) takes the summed gradients.  Global-norm
    clipping would need the split weights' norms summed over the model
    group, and is refused with a model axis."""
    data_group, n_data = mesh.get_group("data"), mesh["data"].size()
    data_rank, n_model = mesh.get_local_rank("data"), mesh["model"].size()
    if n_model > 1 and optimizer.grad_clip > 0:
        raise ValueError("grad_clip with a model axis: the global norm of "
                         "split weights is not taken")
    split = {id(m.weight) for m in predictor.modules()
             if isinstance(m, ColumnShardedLinear)}

    def step(atoms1, adj1, atoms2, adj2, mask1, mask2, labels):
        args = [x.chunk(n_data)[data_rank]
                for x in (atoms1, adj1, atoms2, adj2, mask1, mask2, labels)]
        *inputs, labels = args
        params = optimizer.params
        for p in params:
            p.grad = None
        logits = predictor(*inputs, deterministic=False)
        if class_num == 1:
            logits = logits.reshape(labels.shape)
        per, valid = sigmoid_ce_elements(logits, labels)
        local = (per * valid).sum()
        totals = torch.stack([local.detach(), valid.sum()])
        dist.all_reduce(totals, group=data_group)
        count = torch.clamp(totals[1], min=1.0)
        (local / (count * n_model)).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        is_split = [id(p) in split for p in params]
        summed = [iter(all_reduce_sum_list(
            [g for g, s in zip(grads, is_split) if s == side],
            data_group if side else None)) for side in (False, True)]
        optimizer.step([next(summed[s]) for s in is_split])
        return totals[0] / count

    return step
