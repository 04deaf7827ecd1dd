"""Pair scoring heads (port of gcnbmp_tpu/models/heads.py).

Only HolE, the flagship's head, is ported so far; the other heads of the
JAX package raise until the port of the padded layout and other heads
(ROADMAP queue 1, item 7)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import MLP
from gcnbmp_tpu_torch.ops.circular import circular_correlation


class HolEHead(nn.Module):
    """Circular correlation -> MLP -> logits (heads.py:19-33)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (32, 16), device=None):
        super().__init__()
        self.mlp = MLP(in_dim, out_dim, hidden_dims, device=device)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        return self.mlp(circular_correlation(left, right))


def make_head(sim_method: str, in_dim: int, out_dim: int,
              hidden_dims: Sequence[int] = (), device=None) -> nn.Module:
    if sim_method == "hole":
        return HolEHead(in_dim, out_dim, hidden_dims, device=device)
    if sim_method in ("ntn", "dist-mult", "mlp", "symmlp", "cosine"):
        raise NotImplementedError(
            f"head {sim_method!r} is not ported yet: it comes with the "
            "padded layout and the other heads (ROADMAP queue 1, item 7)")
    raise ValueError(f"unknown sim_method {sim_method!r}")
