"""Readouts over the padded layout (port of gcnbmp_tpu/models/readouts.py:31-107).

Each takes per-atom states (B, N, C) and an optional (B, N) mask (1 on
real atoms); ``mask=None`` takes every slot, as the reference does with
its live padding.

- ``CommonGGNNReadout``: sum over atoms of sigmoid(i(x)) * act(j(x)),
  x = [h, h0] (or h alone), then ``activation_agg``;
- ``Set2Set``: q* = 0; per step q = LSTM(q*), a = softmax over atoms of
  h . q (masked with -1e9, then multiplied by the mask), r = sum a h,
  q* = [q, r]; returns (B, 2C);
- ``MPNNReadout``: Set2Set, then ``linear1`` -> relu -> ``linear2``;
- ``NFPReadout``: the sum over atoms of the softmax over channels of
  ``output_weight(h)``.

No kernel of the JAX package computes these on the padded layout; the
port runs them as PyTorch ops, on the card when the tensors are there.
Parameter names follow the flax trees.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import GraphLinear, OptimizedLSTMCell

NEG = -1e9
SET2SET_STEPS = 3  # MPNNReadout's processing_steps in the JAX package


def _masked_sum(g: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        g = g * mask[..., None]
    return g.sum(dim=-2)


class CommonGGNNReadout(nn.Module):
    """``in_features`` is x's width: h's, or h's and h0's together."""

    def __init__(self, in_features: int, out_dim: int, nobias: bool = False,
                 activation: Optional[Callable] = None,
                 activation_agg: Optional[Callable] = None, device=None):
        super().__init__()
        self.activation = activation
        self.activation_agg = activation_agg
        self.i = GraphLinear(in_features, out_dim, bias=not nobias,
                             device=device)
        self.j = GraphLinear(in_features, out_dim, bias=not nobias,
                             device=device)

    def forward(self, h, h0=None, mask=None):
        x = h if h0 is None else torch.cat([h, h0], dim=-1)
        value = self.j(x)
        if self.activation is not None:
            value = self.activation(value)
        g = _masked_sum(torch.sigmoid(self.i(x)) * value, mask)
        return g if self.activation_agg is None else self.activation_agg(g)


class Set2Set(nn.Module):
    def __init__(self, channels: int, processing_steps: int = SET2SET_STEPS,
                 device=None):
        super().__init__()
        self.channels = channels
        self.processing_steps = processing_steps
        self.lstm = OptimizedLSTMCell(2 * channels, channels, device=device)

    def forward(self, h, mask=None):
        b, _, ch = h.shape
        c = h.new_zeros((b, self.channels))
        hh = h.new_zeros((b, self.channels))
        q_star = h.new_zeros((b, 2 * ch))
        for _ in range(self.processing_steps):
            (c, hh), q = self.lstm((c, hh), q_star)
            e = torch.einsum("bnc,bc->bn", h, q)
            if mask is not None:
                e = torch.where(mask > 0, e, torch.full_like(e, NEG))
            a = torch.softmax(e, dim=1)
            if mask is not None:
                a = a * mask
            r = torch.einsum("bn,bnc->bc", a, h)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


class MPNNReadout(nn.Module):
    def __init__(self, out_dim: int, hidden_dim: int,
                 processing_steps: int = SET2SET_STEPS, device=None):
        super().__init__()
        self.set2set = Set2Set(hidden_dim, processing_steps, device=device)
        self.linear1 = nn.Linear(2 * hidden_dim, hidden_dim, device=device)
        self.linear2 = nn.Linear(hidden_dim, out_dim, device=device)

    def forward(self, h, mask=None):
        g = self.set2set(h, mask)
        return self.linear2(torch.relu(self.linear1(g)))


class NFPReadout(nn.Module):
    def __init__(self, in_features: int, out_dim: int, device=None):
        super().__init__()
        self.output_weight = GraphLinear(in_features, out_dim, device=device)

    def forward(self, h, mask=None):
        return _masked_sum(torch.softmax(self.output_weight(h), dim=-1), mask)
