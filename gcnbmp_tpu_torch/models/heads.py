"""Pair scoring heads (port of gcnbmp_tpu/models/heads.py):
(left (B, in_dim), right (B, in_dim)) -> logits (B, out_dim).

flax infers each head's input width; here the caller passes it as
``in_dim``: the molecule embedding width, or the co-attention output
width (3 D for ``bimpm``).  Sub-module and parameter names follow the
flax trees (``mlp``, ``bilinear``, ``W_diag``, ``out``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.layers import MLP, Bilinear
from gcnbmp_tpu_torch.ops.circular import circular_correlation

NTN_SLICES = 8    # NTNHead.ntn_out_dim
DM_WIDTH = 8      # DistMultHead.dm_out_dim
COSINE_EPS = 1e-8


class HolEHead(nn.Module):
    """Circular correlation -> MLP -> logits (heads.py:19-33)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (32, 16), device=None):
        super().__init__()
        self.mlp = MLP(in_dim, out_dim, hidden_dims, device=device)

    def forward(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        return self.mlp(circular_correlation(left, right))


class NTNHead(nn.Module):
    """Bilinear tensor layer of ``NTN_SLICES`` slices -> MLP
    (heads.py:36-48)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (16,), device=None):
        super().__init__()
        self.bilinear = Bilinear(in_dim, in_dim, NTN_SLICES, device=device)
        self.mlp = MLP(NTN_SLICES, out_dim, hidden_dims, device=device)

    def forward(self, left, right):
        return self.mlp(self.bilinear(left, right))


class DistMultHead(nn.Module):
    """Diagonal bilinear (left * right) @ W_diag -> MLP (heads.py:51-66)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (16,), device=None):
        super().__init__()
        self.W_diag = nn.Parameter(torch.empty(in_dim, DM_WIDTH, device=device))
        self.mlp = MLP(DM_WIDTH, out_dim, hidden_dims, device=device)

    def forward(self, left, right):
        return self.mlp((left * right) @ self.W_diag)


class MLPHead(nn.Module):
    """concat(left, right) -> MLP (heads.py:69-80); ``right_dim``, right's
    width when it is not left's (the research predictor's two sides)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (32, 16),
                 right_dim: Optional[int] = None, device=None):
        super().__init__()
        width = in_dim + (in_dim if right_dim is None else right_dim)
        self.mlp = MLP(width, out_dim, hidden_dims, device=device)

    def forward(self, left, right):
        return self.mlp(torch.cat([left, right], dim=-1))


class SymMLPHead(nn.Module):
    """concat(left + right, left * right) -> MLP, symmetric in the pair
    (heads.py:83-96)."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (32, 16), device=None):
        super().__init__()
        self.mlp = MLP(2 * in_dim, out_dim, hidden_dims, device=device)

    def forward(self, left, right):
        return self.mlp(torch.cat([left + right, left * right], dim=-1))


class CosineHead(nn.Module):
    """Cosine similarity, then a Dense ``out`` when out_dim > 1
    (heads.py:99-115)."""

    def __init__(self, in_dim: int, out_dim: int = 1, device=None):
        super().__init__()
        if out_dim > 1:
            self.out = nn.Linear(1, out_dim, device=device)

    def forward(self, left, right):
        num = (left * right).sum(-1, keepdim=True)
        den = (torch.linalg.vector_norm(left, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(right, dim=-1, keepdim=True))
        sim = num / torch.clamp(den, min=COSINE_EPS)
        return self.out(sim) if hasattr(self, "out") else sim


HEADS = {"hole": HolEHead, "ntn": NTNHead, "dist-mult": DistMultHead,
         "mlp": MLPHead, "symmlp": SymMLPHead, "cosine": CosineHead}


def make_head(sim_method: str, in_dim: int, out_dim: int,
              hidden_dims: Sequence[int] = (), device=None) -> nn.Module:
    """The head the JAX ``make_packed_predictor`` builds for
    ``sim_method``: every head but ``cosine`` takes ``hidden_dims`` (the
    config's ``net_hidden_dims``)."""
    if sim_method not in HEADS:
        raise ValueError(f"unknown sim_method {sim_method!r}; available: "
                         f"{sorted(HEADS)}")
    if sim_method == "cosine":
        return CosineHead(in_dim, out_dim, device=device)
    return HEADS[sim_method](in_dim, out_dim, tuple(hidden_dims),
                             device=device)
