"""NFP (neural fingerprint) (port of gcnbmp_tpu/models/nfp.py:25-89).

Degree-conditioned linears over a plain adjacency with self-loops:
``sigmoid(sum_d linear_d(where(deg == d, A h, 0)))`` for d in
1..max_degree+1.  Every linear adds its bias to every atom, so an atom
whose degree has no linear gets sigmoid of the biases' sum (0.5 at their
zero initialization), as in the JAX module.  ``NFP`` is the padded
encoder: the plain adjacency is the edge types' sum clipped to [0, 1]
plus self-loops (on real atoms only when a mask is given), each layer
has its own ``update_{i}`` and ``readout_{i}``, and the readouts add up
over the layers (``concat_hidden``: every running sum, concatenated).  No
kernel of the JAX package computes NFP: its trainer runs it as XLA ops
on the ``coo`` and padded paths and refuses ``fused`` for it.  The port
runs it as PyTorch ops on the card, the same design.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, EmbedAtomID, GraphLinear)
from gcnbmp_tpu_torch.models.readouts import NFPReadout


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


class NFP(nn.Module):
    """``forward(atoms, adj, mask=None, deterministic=True,
    generator=None)`` -> (g, aux)."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 max_degree: int = 6, n_atom_types: int = MAX_ATOMIC_NUM,
                 concat_hidden: bool = False, device=None):
        super().__init__()
        self.n_layers = n_layers
        self.concat_hidden = concat_hidden
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(n_layers):
            self.add_module(f"update_{i}", NFPUpdate(
                hidden_dim, hidden_dim, max_degree, device=device))
            self.add_module(f"readout_{i}", NFPReadout(
                hidden_dim, out_dim, device=device))
        self.out_width = out_dim * (n_layers if concat_hidden else 1)

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None):
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        plain = adj.sum(dim=1).clamp(0.0, 1.0) if adj.dim() == 4 else adj
        n = plain.shape[-1]
        eye = torch.eye(n, dtype=plain.dtype, device=plain.device)[None]
        if mask is not None:
            plain = plain + eye * mask[:, :, None] * mask[:, None, :]
        else:
            plain = plain + eye
        deg = plain.sum(dim=1).to(torch.int32)
        g = 0.0
        g_list = []
        for i in range(self.n_layers):
            h = getattr(self, f"update_{i}")(h, plain, deg)
            g = g + getattr(self, f"readout_{i}")(h, mask)
            if self.concat_hidden:
                g_list.append(g)
        aux = {"atoms": h, "h0": None, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        return g, aux
