"""GGNN message function (port of gcnbmp_tpu/models/ggnn.py:62-87)."""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GraphLinear
from gcnbmp_tpu_torch.ops.aggregate import edge_type_aggregate

NUM_EDGE_TYPE = 4


class GGNNMessage(nn.Module):
    """Edge-type-conditioned message + aggregation.  The GraphLinear
    output (..., 4H) has the edge type as its FASTEST axis, as in the
    reference transcription, so weights are layout-compatible."""

    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.message = GraphLinear(hidden_dim, NUM_EDGE_TYPE * hidden_dim,
                                   device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """h (B, N, H), adj (B, E, N, N) -> (B, N, H)."""
        b, n, _ = h.shape
        m = self.message(h).reshape(b, n, self.hidden_dim, NUM_EDGE_TYPE)
        return edge_type_aggregate(adj, m.permute(0, 3, 1, 2))
