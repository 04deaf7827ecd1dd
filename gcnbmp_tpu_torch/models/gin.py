"""GIN layer (port of gcnbmp_tpu/models/gin.py:27-53).

Per layer: the neighbour sum over the adjacency summed over edge types,
plus the atom itself, then ``linear_g1`` -> relu -> ``linear_g2`` ->
relu.  The packed encoder runs it deterministic (the trainer refuses
dropout), so the layer has no dropout.  No kernel of the JAX package
computes GIN: its trainer runs it as XLA ops on the ``coo`` path and
refuses ``fused`` for it.  The port runs it as PyTorch ops on the card,
the same design.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GraphLinear


class GINUpdate(nn.Module):
    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.linear_g1 = GraphLinear(hidden_dim, hidden_dim, device=device)
        self.linear_g2 = GraphLinear(hidden_dim, hidden_dim, device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """h (B, N, H), adj (B, 4, N, N) -> (B, N, H)."""
        sum_h = torch.bmm(adj.sum(dim=1), h) + h
        return torch.relu(self.linear_g2(torch.relu(self.linear_g1(sum_h))))
