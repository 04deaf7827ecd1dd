"""Jumping-knowledge layer aggregation for the packed GGNN (port of
gcnbmp_tpu/models/ggnn_extras.py:160-241: ``_bi_rnn`` and
``LayerAggregator``).

The aggregator fuses the per-layer atom states h_1..h_L into one matrix
for the readout, per atom, so it rides the packed tiles unchanged (pad
slots are masked at the readout).  No kernel of the JAX package computes
it: its trainer runs it as XLA ops on the ``coo`` path and refuses it on
``fused``.  The port runs it as PyTorch ops on the card, the same design.

Parameter names follow the flax tree: ``rnn_fwd``/``rnn_bwd`` (flax's
``OptimizedLSTMCell`` or ``GRUCell``, ``models.layers``) and
``attn_dense`` (a Dense of L outputs).
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GRUCell, OptimizedLSTMCell

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
