"""The GGNN-dev research encoders over the padded layout (port of
gcnbmp_tpu/models/ggnn_dev.py:37-132), the ``ggnn-dev*`` methods.

A trimmed GGNN that keeps every layer's atom states (``aux['h_list']``)
and every layer's gated readout (``aux['g_list']``), with one of four
update rules after the message ``update_{i}`` (tied: one) of each layer:

- ``gru``: the shared Chainer GRU ``gru`` over [h ‖ m], as in GGNN;
- ``self_loop``: m += ``self_loop_{i}``(h), then the GRU;
- ``fuse``: h = r·h + f·z with z = tanh(``fuse_z``[h ‖ m]),
  r = sigmoid(``fuse_r``[h ‖ m]), f = sigmoid(``fuse_f``[h ‖ m]) (one set
  for every layer); dropout falls on r·h before f·z is added;
- ``gate``: α = sigmoid(``gate_{i}``[h ‖ m]), h = (1 - α)·h + α·m.

The other rules drop h after the update.  Each layer is read out by
``readout_0`` (``readout_{i}`` per layer with ``concat_hidden``), even
when the sum pool wins: with ``sum_pool_readout`` (the default, the
reference's override) g is the sum of the last layer's h over the masked
atoms, H wide; without it g is the last layer's readout, D wide; with
``concat_hidden`` it is the L readouts side by side.  The JAX package
runs this as XLA ops (no Pallas kernel), and so does the port, on the
card when the tensors are there.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from gcnbmp_tpu_torch.models.ggnn import GatedReadout, GGNNMessage
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, ChainerGRUCell, EmbedAtomID, GraphLinear, dropout)

VARIANTS = ("gru", "fuse", "gate", "self_loop")


class GGNNDev(nn.Module):
    """``forward(atoms, adj, mask=None, deterministic=True,
    generator=None)`` -> (g (B, out_width), aux with ``atoms``, ``h0``,
    ``h_list`` and ``g_list``)."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM,
                 concat_hidden: bool = False, weight_tying: bool = True,
                 dropout_rate: float = 0.0, update_variant: str = "gru",
                 sum_pool_readout: bool = True, device=None):
        super().__init__()
        if update_variant not in VARIANTS:
            raise ValueError(f"unknown update_variant {update_variant!r}")
        self.out_dim = out_dim
        self.n_layers = n_layers
        self.concat_hidden = concat_hidden
        self.weight_tying = weight_tying
        self.dropout_rate = dropout_rate
        self.update_variant = update_variant
        self.sum_pool_readout = sum_pool_readout
        h = hidden_dim
        self.embed = EmbedAtomID(n_atom_types, h, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(h, device=device))
            if update_variant == "self_loop":
                self.add_module(f"self_loop_{i}",
                                GraphLinear(h, h, device=device))
            if update_variant == "gate":
                self.add_module(f"gate_{i}",
                                nn.Linear(2 * h, h, device=device))
        if update_variant in ("gru", "self_loop"):
            self.gru = ChainerGRUCell(2 * h, h, device=device)
        if update_variant == "fuse":
            for name in ("fuse_z", "fuse_r", "fuse_f"):
                self.add_module(name, nn.Linear(2 * h, h, device=device))
        for i in range(n_layers if concat_hidden else 1):
            self.add_module(f"readout_{i}",
                            GatedReadout(h, h, out_dim, device=device))
        self.out_width = (out_dim * n_layers if concat_hidden
                          else h if sum_pool_readout else out_dim)

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        h0 = h
        state = torch.zeros_like(h)
        h_list, g_list = [], []
        variant = self.update_variant
        for step in range(self.n_layers):
            idx = 0 if self.weight_tying else step
            m = getattr(self, f"update_{idx}")(h, adj)
            if variant == "self_loop":
                m = m + getattr(self, f"self_loop_{idx}")(h)
            x = torch.cat([h, m], dim=-1)
            if variant in ("gru", "self_loop"):
                state = self.gru(state, x)
                h = state
            elif variant == "fuse":
                z = torch.tanh(self.fuse_z(x))
                r = torch.sigmoid(self.fuse_r(x))
                f = torch.sigmoid(self.fuse_f(x))
                h = dropout(r * h, self.dropout_rate, deterministic,
                            generator) + f * z
            else:
                alpha = torch.sigmoid(getattr(self, f"gate_{idx}")(x))
                h = (1.0 - alpha) * h + alpha * m
            if variant != "fuse":
                h = dropout(h, self.dropout_rate, deterministic, generator)
            readout = getattr(self, "readout_"
                              f"{step if self.concat_hidden else 0}")
            h_list.append(h)
            g_list.append(readout(h, h0, mask))
        aux = {"atoms": h, "h0": h0, "h_list": h_list, "g_list": g_list}
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        if self.sum_pool_readout:
            hm = h if mask is None else h * mask[..., None]
            return hm.sum(dim=1), aux
        return g_list[-1], aux
