"""GGNN over the padded layout (port of gcnbmp_tpu/models/ggnn.py:40-265).

- ``GatedReadout``: sum over atoms of sigmoid(i([h, h0])) * j(h);
- ``GGNNMessage``: edge-type-conditioned message + aggregation; the
  GraphLinear output (..., 4H) has the edge type as its FASTEST axis, as
  in the reference transcription, so weights are layout-compatible;
- ``GGNNUpdate``: one message step and its own GRU (standalone use);
- ``GGNN``: the encoder.  One GRU (``gru``) is shared by every layer,
  its state chained across the layers; the messages are one tied
  ``update_0`` or untied ``update_{i}``.  Dropout is applied to h after
  each layer, not to the GRU state.  ``concat_hidden`` reads each layer
  out with its own ``readout_{i}``; a layer aggregator
  (``models.ggnn_extras``) feeds ``readout_agg``.  ``mask=None`` keeps
  the reference's live padding: pad atoms carry embed(0) into the
  readout sum.  Float ``atoms`` are taken as embedded states.

The padded GGNN's aggregation is one batched product per layer, the
JAX package's ``edge_type_aggregate`` (an XLA dot_general, no Pallas
kernel): the port runs it as ``torch.bmm``, on the card when the tensors
are there.  The research options run the blocks of
``models.ggnn_extras`` the same way: ``use_attention`` (``attention_{i}``,
one per layer unless ``attention_tying``) transforms h after each GRU
step but not the GRU's state; ``message_function='edge_network'`` makes
each ``update_{i}`` a ``GGNNEdgeNetwork``; ``readout_function='set2vec'``
makes each ``readout_{i}`` a ``Set2Vec`` over [h ‖ h0]; ``context`` runs a
BiLSTM of H/2 per direction along the atom axis before h0 is taken,
over all N padded slots and without sequence lengths, so the backward
direction reads the pad first (flax names its two cells
``OptimizedLSTMCell_0`` and ``_1``: they sit in the encoder's scope, not
under the ``nn.RNN`` wrappers).  ``update_attention`` is refused with the
JAX module's reason, batch normalization because the JAX trainer cannot
take a step with it (its train step applies no ``batch_stats``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from gcnbmp_tpu_torch.models import ggnn_extras
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, ChainerGRUCell, EmbedAtomID, GraphLinear,
    OptimizedLSTMCell, dropout, lstm_scan)
from gcnbmp_tpu_torch.ops.aggregate import edge_type_aggregate

NUM_EDGE_TYPE = 4

BN_REFUSAL = (
    "batch normalization: the JAX trainer cannot take a step with it "
    "(Trainer._init_state keeps only variables['params'] and "
    "make_train_step applies {'params': params} without the batch_stats "
    "collection, gcnbmp_tpu/train/loop.py:779, :227-233, so flax raises "
    "ScopeCollectionNotFound), and the port adds no feature the JAX "
    "package lacks")


class GatedReadout(nn.Module):
    """g = sum_atoms sigmoid(i([h, h0])) * j(h), with h ``in_h`` and h0
    ``in_h0`` wide."""

    def __init__(self, in_h: int, in_h0: int, out_dim: int, device=None):
        super().__init__()
        self.i = GraphLinear(in_h + in_h0, out_dim, device=device)
        self.j = GraphLinear(in_h, out_dim, device=device)

    def forward(self, h, h0, mask=None):
        g = torch.sigmoid(self.i(torch.cat([h, h0], dim=-1))) * self.j(h)
        if mask is not None:
            g = g * mask[..., None]
        return g.sum(dim=-2)


class GGNNMessage(nn.Module):
    """Edge-type-conditioned message + aggregation over (B, N, H) states
    and the (B, 4, N, N) adjacency."""

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


class GGNNUpdate(nn.Module):
    """One message-passing step with its own GRU (``msg``, ``gru``)."""

    def __init__(self, hidden_dim: int, device=None):
        super().__init__()
        self.msg = GGNNMessage(hidden_dim, device=device)
        self.gru = ChainerGRUCell(2 * hidden_dim, hidden_dim, device=device)

    def forward(self, h, adj):
        return self.gru(h, torch.cat([h, self.msg(h, adj)], dim=-1))


class GGNN(nn.Module):
    """Gated Graph Neural Network encoder: ``forward(atoms, adj, mask=None,
    deterministic=True, generator=None)`` -> (g (B, out_width), aux with
    ``atoms``, ``h0``, ``h_list`` and ``g_list``).  ``generator`` feeds
    dropout in training."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM,
                 concat_hidden: bool = False, weight_tying: bool = True,
                 dropout_rate: float = 0.0,
                 batch_normalization: bool = False,
                 layer_aggregator: Optional[str] = None,
                 use_attention: bool = False, update_attention: bool = False,
                 attention_tying: bool = True,
                 message_function: str = "matrix_multiply",
                 edge_hidden_dim: int = 16,
                 readout_function: str = "graph_level",
                 num_timesteps: int = 3, num_output_hidden_layers: int = 0,
                 output_hidden_dim: int = 16,
                 context: bool = False, device=None):
        super().__init__()
        if update_attention:
            raise NotImplementedError(
                "the reference's update_with_attention has an internal shape "
                "mismatch and cannot execute (models/ggnn.py:265-331: "
                "Linear(hidden->hidden) output reshaped to 2*hidden); "
                "use use_attention (masked self-attention) instead")
        if message_function not in ("matrix_multiply", "edge_network"):
            raise ValueError(f"no such message function {message_function!r}")
        if batch_normalization:
            raise ValueError(BN_REFUSAL)
        self.n_layers = n_layers
        self.concat_hidden = concat_hidden
        self.weight_tying = weight_tying
        self.attention_tying = attention_tying
        self.use_attention = use_attention
        self.context = context
        self.dropout_rate = dropout_rate
        h = hidden_dim
        self.embed = EmbedAtomID(n_atom_types, h, device=device)
        if context:
            self.OptimizedLSTMCell_0 = OptimizedLSTMCell(h, h // 2,
                                                         device=device)
            self.OptimizedLSTMCell_1 = OptimizedLSTMCell(h, h // 2,
                                                         device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(h, device=device)
                            if message_function == "matrix_multiply" else
                            ggnn_extras.GGNNEdgeNetwork(h, edge_hidden_dim,
                                                        device=device))
        self.gru = ChainerGRUCell(2 * h, h, device=device)
        if use_attention:
            for i in range(1 if attention_tying else n_layers):
                self.add_module(f"attention_{i}",
                                ggnn_extras.MaskedSelfAttention(
                                    h, h, device=device))
        # the JAX module creates readout_0 even with an aggregator, but
        # only a called module has parameters
        for i in range(n_layers if concat_hidden else
                       (0 if layer_aggregator else 1)):
            self.add_module(f"readout_{i}", GatedReadout(
                h, h, out_dim, device=device)
                if readout_function != "set2vec" else ggnn_extras.Set2Vec(
                    2 * h, out_dim, num_timesteps, num_output_hidden_layers,
                    output_hidden_dim, device=device))
        self.set2vec = readout_function == "set2vec"
        self.layer_aggregator = None
        if layer_aggregator:
            self.layer_aggregator = ggnn_extras.LayerAggregator(
                layer_aggregator, h, n_layers, device=device)
            w = ggnn_extras.aggregated_width(layer_aggregator, h, n_layers)
            self.readout_agg = GatedReadout(w, w, out_dim, device=device)
        self.out_width = (out_dim * n_layers
                          if concat_hidden and not layer_aggregator
                          else out_dim)

    def _readout(self, i, h, h0, mask):
        ro = getattr(self, f"readout_{i}")
        if self.set2vec:
            return ro(torch.cat([h, h0], dim=-1), mask)
        return ro(h, h0, mask)

    def forward(self, atoms, adj, mask=None, deterministic: bool = True,
                generator=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        if self.context:
            h = torch.cat([
                lstm_scan(self.OptimizedLSTMCell_0, h),
                lstm_scan(self.OptimizedLSTMCell_1, h, reverse=True)],
                dim=-1)
        h0 = h
        g_list, h_list = [], []
        state = torch.zeros_like(h)
        for step in range(self.n_layers):
            msg = getattr(self, f"update_{0 if self.weight_tying else step}")
            state = self.gru(state, torch.cat([h, msg(h, adj)], dim=-1))
            h = state
            if self.use_attention:
                h = getattr(self, "attention_"
                            f"{0 if self.attention_tying else step}")(h, adj)
            h = dropout(h, self.dropout_rate, deterministic, generator)
            if self.concat_hidden:
                g_list.append(self._readout(step, h, h0, mask))
            if self.layer_aggregator is not None:
                h_list.append(h)
        aux = {"atoms": h, "h0": h0, "h_list": h_list, "g_list": g_list}
        if self.layer_aggregator is not None:
            return self.readout_agg(*self.layer_aggregator(h_list, h0),
                                    mask), aux
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        return self._readout(0, h, h0, mask), aux
