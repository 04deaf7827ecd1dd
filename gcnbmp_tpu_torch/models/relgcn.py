"""RelGCN (port of gcnbmp_tpu/models/relgcn.py:24-94).

Per layer: ``h' = tanh(self(h) + sum_e A_e edge_e(h))``, then the gated
readout over h (no biases, tanh).  ``RelGCNUpdate`` is the layer, which
the packed encoder (``models.packed.PackedRelGCN``) shares; ``RelGCN`` the
padded encoder.  No kernel of the JAX package computes RelGCN: its
trainer runs it as XLA ops on the ``coo`` and padded paths and refuses
``fused`` for it.  The port runs it as PyTorch ops on the card, the same
design.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.ggnn import NUM_EDGE_TYPE
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, EmbedAtomID, GraphLinear)
from gcnbmp_tpu_torch.models.readouts import CommonGGNNReadout
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


class RelGCN(nn.Module):
    """The padded RelGCN encoder: ``forward(atoms, adj, mask=None,
    deterministic=True, generator=None)`` -> (g, aux).  The channel list
    defaults to [hidden] * (n_layers + 1), as the JAX factory builds it.
    Integer atoms are embedded (``embed``); float atoms are taken as
    embedded states when ``pre_embedded`` (the JAX module's saliency
    entry), and the DrugFP-feature input (``embed_linear``), which no
    trainer path feeds, is refused."""

    def __init__(self, out_dim: int = 64, hidden_dim: int = 16,
                 n_layers: int = 2, ch_list: Optional[Sequence[int]] = None,
                 n_atom_types: int = MAX_ATOMIC_NUM, scale_adj: bool = False,
                 pre_embedded: bool = False, device=None):
        super().__init__()
        chs = list(ch_list) if ch_list else [hidden_dim] * (n_layers + 1)
        self.n_convs = len(chs) - 1
        self.scale_adj = scale_adj
        self.pre_embedded = pre_embedded
        self.embed = EmbedAtomID(n_atom_types, chs[0], device=device)
        for i in range(self.n_convs):
            self.add_module(f"conv_{i}", RelGCNUpdate(chs[i], chs[i + 1],
                                                      device=device))
        self.readout = CommonGGNNReadout(chs[-1], out_dim, nobias=True,
                                         activation=torch.tanh, device=device)
        self.out_width = out_dim

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None):
        if not atoms.is_floating_point():
            h = self.embed(atoms)
        elif self.pre_embedded:
            h = atoms
        else:
            raise ValueError("RelGCN over raw float atom features "
                             "(embed_linear): no trainer path feeds them")
        if self.scale_adj:
            adj = rescale_adj(adj)
        for i in range(self.n_convs):
            h = torch.tanh(getattr(self, f"conv_{i}")(h, adj))
        g = self.readout(h, None, mask)
        return g, {"atoms": h, "h0": None, "h_list": [], "g_list": []}
