"""GGNN's optional blocks (port of gcnbmp_tpu/models/ggnn_extras.py):
masked self-attention, the edge-network message, the input-less LSTM and
the set2vec readout over the padded layout, and the jumping-knowledge
layer aggregation over the packed or padded one.

- ``MaskedSelfAttention`` (:33): h -> W h; e_ij = leaky_relu(a([Wh_i ‖
  Wh_j])), computed as a_1 . Wh_i + a_2 . Wh_j; softmax over j of e_ij
  where atoms i and j share a bond, -9e15 elsewhere, so an atom with no
  neighbour (an isolated atom, a pad atom) gets a uniform softmax over
  every slot, as in the JAX module; h' = elu(attention @ Wh).
- ``GGNNEdgeNetwork`` (:62): the 5 edge vectors (non-edge, 4 bond types)
  through ``hidden_{i}`` and ``output`` to 5 H x H matrices; message_i =
  sum_j M(e_ij) h_j, whose non-edge term M_0 sum_j h_j runs over every
  padded slot (no mask, the reference's pad-size dependence, kept).
- ``LSTMWithoutInput`` (:94): an LSTM whose gates read only the previous
  output; the cell candidate passes through sigmoid and then tanh, the
  reference's quirk, kept.
- ``Set2Vec`` (:113): the raw ``attention_w1``/``attention_w2``/
  ``attention_v``, the ``lstm_block`` loop of ``num_timesteps`` reads
  (energies -9e15 off the mask, softmax, then times the mask), then the
  ``ff_hidden_{i}`` layers and ``ff_output``.
- ``_bi_rnn`` and ``LayerAggregator`` (:160-241).

No kernel of the JAX package computes any of these: its trainer runs
them as XLA ops (the aggregator on ``coo``; the rest on the padded
layout).  The port runs them as PyTorch ops on the card, the same
design.  Parameter names follow the flax trees: ``rnn_fwd``/``rnn_bwd``
(flax's ``OptimizedLSTMCell`` or ``GRUCell``, ``models.layers``) and
``attn_dense`` (a Dense of L outputs) for the aggregator.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

from gcnbmp_tpu_torch.models.layers import GRUCell, OptimizedLSTMCell

NEG_BIG = -9e15
NUM_EDGE_TYPE = 4

MODES = ("concat", "max-pool", "avg", "lstm", "gru", "lstm-attn", "gru-attn",
         "attn")
RNN_MODES = ("lstm", "gru", "lstm-attn", "gru-attn")


def aggregated_width(mode: str, hidden_dim: int, n_layers: int) -> int:
    """The width of the aggregated atom states (and of the h0 returned
    with them): L*H for ``concat``, 2H for the bidirectional RNN modes,
    H otherwise."""
    if mode == "concat":
        return n_layers * hidden_dim
    if mode in RNN_MODES:
        return 2 * hidden_dim
    return hidden_dim


class MaskedSelfAttention(nn.Module):
    """GAT-style attention over the bonded neighbours of each atom:
    ``forward(h (B, N, in_dim), adj (B, E, N, N))`` -> (B, N, hidden)."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.linear_transform = nn.Linear(in_dim, hidden_dim, bias=False,
                                          device=device)
        self.neural_network = nn.Linear(2 * hidden_dim, 1, bias=False,
                                        device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        wh = self.linear_transform(h)
        a_i, a_j = self.neural_network.weight[0].chunk(2)
        e = F.leaky_relu((wh @ a_i)[:, :, None] + (wh @ a_j)[:, None, :],
                         0.01)
        e = torch.where(adj.sum(dim=1) > 0, e, torch.full_like(e, NEG_BIG))
        return F.elu(torch.softmax(e, dim=2) @ wh)


class GGNNEdgeNetwork(nn.Module):
    """The ``edge_network`` message: ``forward(h (B, N, node_dim), adj
    (B, E, N, N))`` -> (B, N, node_dim)."""

    def __init__(self, node_dim: int, edge_hidden_dim: int = 16,
                 n_hidden_layers: int = 0, device=None):
        super().__init__()
        self.node_dim = node_dim
        self.n_hidden_layers = n_hidden_layers
        width = NUM_EDGE_TYPE
        for i in range(n_hidden_layers):
            self.add_module(f"hidden_{i}", nn.Linear(width, edge_hidden_dim,
                                                     device=device))
            width = edge_hidden_dim
        self.output = nn.Linear(width, node_dim * node_dim, device=device)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        w = self.output.weight
        z = torch.cat([w.new_zeros((1, NUM_EDGE_TYPE)),
                       torch.eye(NUM_EDGE_TYPE, dtype=w.dtype,
                                 device=w.device)])
        for i in range(self.n_hidden_layers):
            z = torch.relu(getattr(self, f"hidden_{i}")(z))
        d = self.node_dim
        mats = self.output(z).reshape(-1, d, d)
        m0, m_types = mats[0], mats[1:]
        hm = torch.einsum("tcd,bjd->btjc", m_types - m0, h)
        h_m0 = torch.einsum("cd,bjd->bc", m0, h)
        return torch.einsum("btij,btjc->bic", adj, hm) + h_m0[:, None, :]


class LSTMWithoutInput(nn.Module):
    """``forward(m_prev (B, in_dim), c_prev (B, node_dim))`` -> (m, c):
    gates ``input_gate``, ``forget_gate``, ``cell_gate`` and
    ``output_gate`` read m_prev alone; c = f c_prev + i tanh(sigmoid(
    cell_gate(m_prev)))."""

    def __init__(self, in_dim: int, node_dim: int, device=None):
        super().__init__()
        for gate in ("input_gate", "forget_gate", "cell_gate", "output_gate"):
            self.add_module(gate, nn.Linear(in_dim, node_dim, device=device))

    def forward(self, mprev: torch.Tensor, cprev: torch.Tensor):
        i_g = torch.sigmoid(self.input_gate(mprev))
        f_g = torch.sigmoid(self.forget_gate(mprev))
        cprime = torch.sigmoid(self.cell_gate(mprev))
        c = f_g * cprev + i_g * torch.tanh(cprime)
        return torch.sigmoid(self.output_gate(mprev)) * torch.tanh(c), c


class Set2Vec(nn.Module):
    """The set2vec readout: ``forward(h (B, N, node_dim), mask=None)`` ->
    (B, output_dim)."""

    def __init__(self, node_dim: int, output_dim: int, num_timesteps: int = 3,
                 num_output_hidden_layers: int = 0,
                 output_hidden_dim: int = 16, device=None):
        super().__init__()
        d = node_dim
        self.num_timesteps = num_timesteps
        self.num_output_hidden_layers = num_output_hidden_layers
        self.attention_w1 = nn.Parameter(torch.empty(d, d, device=device))
        self.attention_w2 = nn.Parameter(torch.empty(d, d, device=device))
        self.attention_v = nn.Parameter(torch.empty(d, 1, device=device))
        self.lstm_block = LSTMWithoutInput(2 * d, d, device=device)
        width = 2 * d
        for i in range(num_output_hidden_layers):
            self.add_module(f"ff_hidden_{i}", nn.Linear(
                width, output_hidden_dim, device=device))
            width = output_hidden_dim
        self.ff_output = nn.Linear(width, output_dim, device=device)

    def forward(self, h: torch.Tensor, mask=None) -> torch.Tensor:
        b, _, d = h.shape
        embedded = h @ self.attention_w1
        m = h.new_zeros((b, 2 * d))
        c = h.new_zeros((b, d))
        for _ in range(self.num_timesteps):
            m_out, c = self.lstm_block(m, c)
            query = (m_out @ self.attention_w2)[:, None, :]
            energies = (torch.tanh(query + embedded)
                        @ self.attention_v)[..., 0]
            if mask is not None:
                energies = torch.where(mask > 0, energies,
                                       torch.full_like(energies, NEG_BIG))
            att = torch.softmax(energies, dim=1)
            if mask is not None:
                att = att * mask
            m = torch.cat([m_out, (att[..., None] * embedded).sum(dim=1)],
                          dim=1)
        for i in range(self.num_output_hidden_layers):
            m = torch.relu(getattr(self, f"ff_hidden_{i}")(m))
        return self.ff_output(m)


def _bi_rnn(cell_fwd, cell_bwd, seq: List[torch.Tensor],
            carry_init: Callable):
    """Run a pair of RNN cells forward and backward over a short list of
    (B*, D) steps; returns the list of (B*, 2D) outputs."""
    outs_f, outs_b = [], []
    carry = carry_init()
    for x in seq:
        carry, y = cell_fwd(carry, x)
        outs_f.append(y)
    carry = carry_init()
    for x in reversed(seq):
        carry, y = cell_bwd(carry, x)
        outs_b.append(y)
    outs_b = list(reversed(outs_b))
    return [torch.cat([f, b], dim=-1) for f, b in zip(outs_f, outs_b)]


class LayerAggregator(nn.Module):
    """Aggregates the per-layer states (each (..., D)) into (h_agg,
    h0_agg) for the readout.  Modes: ``concat``, ``max-pool``, ``avg``,
    ``lstm``, ``gru`` (the forward RNN's last output beside the backward
    RNN's first), ``lstm-attn``, ``gru-attn`` (a per-channel softmax over
    the layers of the bidirectional outputs) and ``attn`` (the same over
    the states themselves).  Any other mode raises NotImplementedError,
    as in the JAX module (the reference's ``self-attn`` is unfinished)."""

    def __init__(self, mode: str, hidden_dim: int, n_layers: int,
                 device=None):
        super().__init__()
        if mode not in MODES:
            raise NotImplementedError(
                f"layer_aggregator={mode!r} (the reference's 'self-attn' "
                "branch is unfinished, ggnn.py:573-579)")
        self.mode = mode
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        d = hidden_dim
        if mode in RNN_MODES:
            cell = OptimizedLSTMCell if mode.startswith("lstm") else GRUCell
            self.rnn_fwd = cell(d, d, device=device)
            self.rnn_bwd = cell(d, d, device=device)
        if mode.endswith("attn"):
            self.attn_dense = nn.Linear(n_layers, n_layers, device=device)

    def _layer_softmax(self, stacked: torch.Tensor) -> torch.Tensor:
        """sum over layers of stacked (R, L, W) weighted per channel by a
        softmax over ``attn_dense`` of the channel's L values."""
        r, n_layers, w = stacked.shape
        a = stacked.transpose(1, 2).reshape(-1, n_layers)
        attn = torch.softmax(self.attn_dense(a), dim=1)
        attn = attn.reshape(r, w, n_layers).transpose(1, 2)
        return (stacked * attn).sum(dim=1)

    def forward(self, h_list: List[torch.Tensor], h0: torch.Tensor):
        mode = self.mode
        if mode == "concat":
            return torch.cat(h_list, dim=-1), torch.cat([h0] * self.n_layers,
                                                        dim=-1)
        if mode == "max-pool":
            return torch.stack(h_list, dim=-2).amax(dim=-2), h0
        if mode == "avg":
            return torch.stack(h_list, dim=-2).mean(dim=-2), h0
        lead, d = h_list[0].shape[:-1], h_list[0].shape[-1]
        if mode == "attn":
            stacked = torch.stack([h.reshape(-1, d) for h in h_list], dim=1)
            return self._layer_softmax(stacked).reshape(*lead, d), h0
        seq = [h.reshape(-1, d) for h in h_list]
        zeros = lambda: seq[0].new_zeros(seq[0].shape)
        if mode.startswith("lstm"):
            init = lambda: (zeros(), zeros())  # flax's (c, h)
        else:
            init = zeros
        outs = _bi_rnn(self.rnn_fwd, self.rnn_bwd, seq, init)  # L x (R, 2D)
        if mode in ("lstm", "gru"):
            agg = torch.cat([outs[-1][:, :d], outs[0][:, d:]], dim=-1)
        else:
            agg = self._layer_softmax(torch.stack(outs, dim=1))
        return agg.reshape(*lead, 2 * d), torch.cat([h0, h0], dim=-1)
