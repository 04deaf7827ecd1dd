"""NFP (neural fingerprint) layer (port of gcnbmp_tpu/models/nfp.py:25-40).

Degree-conditioned linears over a plain adjacency with self-loops:
``sigmoid(sum_d linear_d(where(deg == d, A h, 0)))`` for d in
1..max_degree+1.  Every linear adds its bias to every atom, so an atom
whose degree has no linear gets sigmoid of the biases' sum (0.5 at their
zero initialization), as in the JAX module.  No kernel of the JAX package
computes NFP: its trainer runs it as XLA ops on the ``coo`` path and
refuses ``fused`` for it.  The port runs it as PyTorch ops on the card,
the same design.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GraphLinear


class NFPUpdate(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 max_degree: int = 6, device=None):
        super().__init__()
        self.max_degree = max_degree
        for d in range(1, max_degree + 2):
            self.add_module(f"linear_d{d}", GraphLinear(
                in_channels, out_channels, device=device))

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                deg: torch.Tensor) -> torch.Tensor:
        """h (B, N, C); adj plain (B, N, N); deg (B, N) integer degrees,
        the self-loop included."""
        fv = torch.bmm(adj, h)
        out = 0.0
        for d in range(1, self.max_degree + 2):
            fvd = torch.where((deg == d)[..., None], fv, torch.zeros_like(fv))
            out = out + getattr(self, f"linear_d{d}")(fvd)
        return torch.sigmoid(out)
