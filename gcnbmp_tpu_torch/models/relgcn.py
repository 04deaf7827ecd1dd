"""RelGCN layer (port of gcnbmp_tpu/models/relgcn.py:24-48).

Per layer: ``h' = self(h) + sum_e A_e edge_e(h)``; the packed encoder
(``models.packed.PackedRelGCN``) applies tanh after it.  No kernel of the
JAX package computes RelGCN: its trainer runs it as XLA ops on the ``coo``
path and refuses ``fused`` for it.  The port runs it as PyTorch ops on
the card, the same design.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.ggnn import NUM_EDGE_TYPE
from gcnbmp_tpu_torch.models.layers import GraphLinear
from gcnbmp_tpu_torch.ops.aggregate import edge_type_aggregate


def rescale_adj(adj: torch.Tensor) -> torch.Tensor:
    """adj / in-degree: the degree summed over (edge type, source) per
    target column; a column with no edges keeps its zeros."""
    num_neighbor = adj.sum(dim=(1, 2))  # (B, N)
    inv = 1.0 / torch.where(num_neighbor != 0, num_neighbor,
                            torch.ones_like(num_neighbor))
    return adj * inv[:, None, None, :]


class RelGCNUpdate(nn.Module):
    """``self`` (in -> out) plus the edge-type messages of ``edge``, one
    linear of width 4 * out whose output is laid out (node, out_ch, edge)
    as in the reference: the edge type is the minor axis."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.add_module("self", GraphLinear(in_channels, out_channels,
                                            device=device))
        self.edge = GraphLinear(in_channels, out_channels * NUM_EDGE_TYPE,
                                device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """h (B, N, in), adj (B, 4, N, N) -> (B, N, out)."""
        b, n, _ = h.shape
        hs = getattr(self, "self")(h)
        m = self.edge(h).reshape(b, n, self.out_channels, NUM_EDGE_TYPE)
        return hs + edge_type_aggregate(adj, m.permute(0, 3, 1, 2))
