"""GIN (port of gcnbmp_tpu/models/gin.py:27-101).

Per layer (``GINUpdate``): the neighbour sum over the adjacency summed
over edge types, plus the atom itself, then ``linear_g1`` -> relu ->
``linear_g2`` -> dropout -> relu.  The packed encoder runs it
deterministic (its trainer refuses dropout); ``GIN`` is the padded
encoder, with ``concat_hidden`` reading each layer out with its own
``readout_{i}``.  The loop runs ``n_layers`` steps (the JAX module's
``quirk_tied_single_layer``, which no factory sets, is not ported).  No
kernel of the JAX package computes GIN: its trainer runs it as XLA ops on
the ``coo`` and padded paths and refuses ``fused`` for it.  The port runs
it as PyTorch ops on the card, the same design.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, EmbedAtomID, GraphLinear, dropout)
from gcnbmp_tpu_torch.models.readouts import CommonGGNNReadout


class GINUpdate(nn.Module):
    def __init__(self, hidden_dim: int, dropout_ratio: float = 0.0,
                 device=None):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.linear_g1 = GraphLinear(hidden_dim, hidden_dim, device=device)
        self.linear_g2 = GraphLinear(hidden_dim, hidden_dim, device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                deterministic: bool = True, generator=None) -> torch.Tensor:
        """h (B, N, H), adj (B, 4, N, N) -> (B, N, H)."""
        sum_h = torch.bmm(adj.sum(dim=1), h) + h
        new_h = self.linear_g2(torch.relu(self.linear_g1(sum_h)))
        return torch.relu(dropout(new_h, self.dropout_ratio, deterministic,
                                  generator))


class GIN(nn.Module):
    """The padded GIN encoder: ``forward(atoms, adj, mask=None,
    deterministic=True, generator=None)`` -> (g, aux)."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM,
                 dropout_ratio: float = 0.5, concat_hidden: bool = False,
                 weight_tying: bool = True, device=None):
        super().__init__()
        self.n_layers = n_layers
        self.concat_hidden = concat_hidden
        self.weight_tying = weight_tying
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GINUpdate(
                hidden_dim, dropout_ratio, device=device))
        for i in range(n_layers if concat_hidden else 1):
            self.add_module(f"readout_{i}", CommonGGNNReadout(
                2 * hidden_dim, out_dim, device=device))
        self.out_width = out_dim * (n_layers if concat_hidden else 1)

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None):
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        h0 = h
        g_list = []
        for step in range(self.n_layers):
            update = getattr(self, f"update_{0 if self.weight_tying else step}")
            h = update(h, adj, deterministic, generator)
            if self.concat_hidden:
                g_list.append(getattr(self, f"readout_{step}")(h, h0, mask))
        aux = {"atoms": h, "h0": h0, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        return self.readout_0(h, h0, mask), aux
