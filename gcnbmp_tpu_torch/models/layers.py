"""Building-block layers with Chainer-matching semantics.

Ports gcnbmp_tpu/models/layers.py:34-176, and flax's
``OptimizedLSTMCell`` for the Set2Set readout.  Module and parameter names
follow the flax trees (``dense``, ``embedding``, ``W_z``...) so that
``convert.from_jax_params`` maps a flax path to a torch name by joining
it with dots.  A flax ``Dense.kernel`` is (in, out); the ``nn.Linear``
weight here is its transpose.  Initialization lives in
``convert.init_params`` (numpy, seeded), not in these constructors.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# chainer_chemistry.config.MAX_ATOMIC_NUM: EmbedAtomID vocabulary size
MAX_ATOMIC_NUM = 117


class GraphLinear(nn.Module):
    """Linear over the last axis of (..., in) (chainer_chemistry's
    GraphLinear); the child is named ``dense`` as in flax."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=bias, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class EmbedAtomID(nn.Module):
    """Atom-ID embedding: a gather with ids clamped to the table, the
    out-of-range semantics of the JAX module (layers.py:85).

    The gather is ``F.embedding``, whose backward sums each row's
    gradient with a sort and a parallel segment reduction.  Indexing the
    table (``embedding[ids]``) gives the same values, but its backward
    walks each run of equal ids in turn, and a 2048-pair batch has ~40 K
    atoms of a few dozen kinds: ~9.8 ms of a 15.4 ms train step on an
    H100 80GB HBM3 at 700 W, against 0.14 ms for ``F.embedding``'s."""

    def __init__(self, num_embeddings: int = MAX_ATOMIC_NUM,
                 features: int = 16, device=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, features, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long().clamp(0, self.embedding.shape[0] - 1)
        return F.embedding(ids, self.embedding)


class ChainerGRUCell(nn.Module):
    """chainer.links.GRU (StatefulGRU) cell, gate order of layers.py:121-129:

        z  = sigmoid(W_z x + U_z h)
        r  = sigmoid(W_r x + U_r h)
        h~ = tanh(W x + U (r * h))
        h' = z * h~ + (1 - z) * h

    Callers start from a zero state, which reproduces Chainer's
    reset-state layer 0."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        lin = lambda i: nn.Linear(i, features, device=device)
        self.W_z, self.U_z = lin(in_features), lin(features)
        self.W_r, self.U_r = lin(in_features), lin(features)
        self.W, self.U = lin(in_features), lin(features)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        z = torch.sigmoid(self.W_z(x) + self.U_z(h))
        r = torch.sigmoid(self.W_r(x) + self.U_r(h))
        h_bar = torch.tanh(self.W(x) + self.U(r * h))
        return z * h_bar + (1.0 - z) * h


class OptimizedLSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell, as ``PackedSet2Set`` uses it: gate
    order i|f|g|o, input kernels ``ii``/``if``/``ig``/``io`` without bias,
    hidden kernels ``hi``/``hf``/``hg``/``ho`` with bias:

        i = sigmoid(W_ii x + W_hi h + b_hi)     (f, o alike; g with tanh)
        c' = f * c + i * g,  h' = o * tanh(c')

    flax draws the hidden kernels orthogonally (``convert.init_params``)."""

    GATES = "ifgo"

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        for gate in self.GATES:
            self.add_module(f"i{gate}", nn.Linear(in_features, features,
                                                  bias=False, device=device))
        for gate in self.GATES:
            self.add_module(f"h{gate}", nn.Linear(features, features,
                                                  device=device))

    def kernels(self):
        """The fused Set2Set kernel's weights: wx (in, 4F), wh (F, 4F),
        b (1, 4F), gates concatenated in i|f|g|o order."""
        get = lambda name: getattr(self, name)
        wx = torch.cat([get(f"i{g}").weight.T for g in self.GATES], dim=-1)
        wh = torch.cat([get(f"h{g}").weight.T for g in self.GATES], dim=-1)
        b = torch.cat([get(f"h{g}").bias for g in self.GATES])[None]
        return wx.contiguous(), wh.contiguous(), b

    def forward(self, carry, x):
        c, h = carry
        pre = {g: getattr(self, f"i{g}")(x) + getattr(self, f"h{g}")(h)
               for g in self.GATES}
        i, f, o = (torch.sigmoid(pre[g]) for g in "ifo")
        g = torch.tanh(pre["g"])
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h


class MLP(nn.Module):
    """ReLU MLP: ``hidden_{i}`` layers, then ``out``."""

    def __init__(self, in_features: int, out_dim: int,
                 hidden_dims: Sequence[int] = (32, 16), device=None):
        super().__init__()
        self.n_hidden = len(hidden_dims)
        d = in_features
        for i, width in enumerate(hidden_dims):
            self.add_module(f"hidden_{i}", nn.Linear(d, width, device=device))
            d = width
        self.out = nn.Linear(d, out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)
