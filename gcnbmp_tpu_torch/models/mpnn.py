"""MPNN over the padded layout (port of gcnbmp_tpu/models/mpnn.py:40-159).

``EdgeNet``: the per-pair edge vector (one-hot over the 4 bond types, or
zero for a non-edge) goes through ``nn1`` -> relu -> ``nn2`` to a C x C
matrix; as it takes 5 values, the 5 matrices M_0 (non-edge) .. M_4 are
computed once per call, and

    in_i = sum_t A_t[i, :] @ (h (M_t - M_0)^T) + M_0 sum_j h_j

and ``out`` the same over the transposed adjacency; returns [in, out].
The non-edge background M_0 sum_j h_j runs over the masked atoms, or with
``mask=None`` over every padded slot, which makes it depend on the pad
size: the reference's behaviour, kept.

``MPNN``: EdgeNet messages (``message_func='ggnn'``: a ``GGNNMessage``,
then the GRU reads [h ‖ m]), one GRU per message function (``gru_{i}``;
tied layers share one, whose state chains across them), and the Set2Set
readout (``models.readouts.MPNNReadout``, ``readout_{i}``), or with
``readout_func='ggnn'`` a ``CommonGGNNReadout`` over [h ‖ h0], per layer
under ``concat_hidden`` too.  The padded MPNN of the JAX package runs no
Pallas kernel (K5 and K4 serve its packed layouts only), and neither does
this one: the port runs it as PyTorch ops, on the card when the tensors
are there.
"""

from __future__ import annotations

import torch
from torch import nn

from gcnbmp_tpu_torch.models.ggnn import NUM_EDGE_TYPE, GGNNMessage
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, ChainerGRUCell, EmbedAtomID)
from gcnbmp_tpu_torch.models.readouts import CommonGGNNReadout, MPNNReadout


class EdgeNet(nn.Module):
    def __init__(self, out_channels: int, edge_hidden_dim: int = 16,
                 device=None):
        super().__init__()
        self.out_channels = out_channels
        self.nn1 = nn.Linear(NUM_EDGE_TYPE, edge_hidden_dim, device=device)
        self.nn2 = nn.Linear(edge_hidden_dim, out_channels * out_channels,
                             device=device)

    def forward(self, h, adj, mask=None):
        """h (B, N, C), adj (B, 4, N, N) -> (B, N, 2C)."""
        ch = self.out_channels
        w = self.nn1.weight
        basis = torch.cat([w.new_zeros((1, NUM_EDGE_TYPE)),
                           torch.eye(NUM_EDGE_TYPE, dtype=w.dtype,
                                     device=w.device)])
        mats = self.nn2(torch.relu(self.nn1(basis))).reshape(5, ch, ch)
        m0, m_types = mats[0], mats[1:]
        hm = torch.einsum("tcd,bjd->btjc", m_types - m0, h)  # (B, 4, N, C)
        h_bg = h if mask is None else h * mask[..., None]
        bg = torch.einsum("cd,bjd->bc", m0, h_bg)[:, None, :]
        message_in = torch.einsum("btij,btjc->bic", adj, hm) + bg
        message_out = torch.einsum("btji,btjc->bic", adj, hm) + bg
        return torch.cat([message_in, message_out], dim=-1)


class MPNN(nn.Module):
    """``forward(atoms, adj, mask=None, deterministic=True,
    generator=None)`` -> (g, aux)."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM,
                 concat_hidden: bool = False, weight_tying: bool = True,
                 message_func: str = "edgenet", readout_func: str = "set2set",
                 edge_hidden_dim: int = 16, device=None):
        super().__init__()
        if message_func not in ("edgenet", "ggnn"):
            raise ValueError(f"invalid message function {message_func!r}")
        if readout_func not in ("set2set", "ggnn"):
            raise ValueError(f"invalid readout function {readout_func!r}")
        self.n_layers = n_layers
        self.concat_hidden = concat_hidden
        self.weight_tying = weight_tying
        self.message_func = message_func
        self.readout_func = readout_func
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"message_{i}", EdgeNet(
                hidden_dim, edge_hidden_dim, device=device)
                if message_func == "edgenet" else
                GGNNMessage(hidden_dim, device=device))
            self.add_module(f"gru_{i}", ChainerGRUCell(
                2 * hidden_dim, hidden_dim, device=device))
        for i in range(n_layers if concat_hidden else 1):
            self.add_module(f"readout_{i}", MPNNReadout(
                out_dim, hidden_dim, device=device)
                if readout_func == "set2set" else CommonGGNNReadout(
                    2 * hidden_dim, out_dim, device=device))
        self.out_width = out_dim * (n_layers if concat_hidden else 1)

    def _readout(self, i, h, h0, mask):
        ro = getattr(self, f"readout_{i}")
        return ro(h, mask) if self.readout_func == "set2set" else ro(h, h0,
                                                                      mask)

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None):
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        h0 = h
        states = [torch.zeros_like(h)
                  for _ in range(1 if self.weight_tying else self.n_layers)]
        g_list = []
        for step in range(self.n_layers):
            k = 0 if self.weight_tying else step
            msg = getattr(self, f"message_{k}")
            x = (msg(h, adj, mask) if self.message_func == "edgenet"
                 else torch.cat([h, msg(h, adj)], dim=-1))
            states[k] = getattr(self, f"gru_{k}")(states[k], x)
            h = states[k]
            if self.concat_hidden:
                g_list.append(self._readout(step, h, h0, mask))
        aux = {"atoms": h, "h0": h0, "h_list": [], "g_list": g_list}
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        return self._readout(0, h, h0, mask), aux
