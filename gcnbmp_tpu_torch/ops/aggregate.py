"""Edge-type message aggregation and the on-device COO adjacency build.

Plain torch counterparts of gcnbmp_tpu/ops/aggregate.py:

- ``edge_type_aggregate`` <- :27-47
- ``adj_from_coo``        <- :55-88   (dense (P, E, T, T) layout)
- ``adj_from_coo_flat``   <- :91-111  (the fused kernel's (P, T, E*T))

The scatter is one ``index_add_`` on the flattened index, with the
index formulas of the JAX package kept verbatim.  JAX scatters with
``mode="drop"``; torch's ``index_add_`` raises (CPU) or device-asserts
(CUDA) on an index out of range, so such indices are masked explicitly:
they add 0 at index 0.  As in JAX, a negative flat index in [-N, 0)
wraps around once before the bounds check.
"""

from __future__ import annotations

import torch


def edge_type_aggregate(adj: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """out[b, i, h] = sum_e sum_j adj[b, e, i, j] * msg[b, e, j, h].

    adj: (B, E, N, N); msg: (B, E, N, H) -> (B, N, H)."""
    b, e, n, _ = adj.shape
    adj_flat = adj.permute(0, 2, 1, 3).reshape(b, n, e * n)
    return torch.bmm(adj_flat, msg.reshape(b, e * n, msg.shape[-1]))


def _scatter_flat(idx: torch.Tensor, e_mask: torch.Tensor, size: int,
                  dtype: torch.dtype) -> torch.Tensor:
    idx = idx.long()
    idx = torch.where(idx < 0, idx + size, idx)
    valid = (idx >= 0) & (idx < size)
    vals = torch.where(valid, e_mask.to(dtype), torch.zeros((), dtype=dtype,
                                                            device=idx.device))
    flat = torch.zeros(size, dtype=dtype, device=idx.device)
    return flat.index_add_(0, torch.where(valid, idx, 0), vals)


def adj_from_coo(e_tile, e_type, e_src, e_dst, e_mask, num_tiles: int,
                 tile: int, num_edge_types: int = 4,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense (P, E, T, T) tile adjacency from a padded COO edge list
    (padding edges carry mask 0 and add nothing wherever they point)."""
    idx = ((e_tile * num_edge_types + e_type) * tile + e_src) * tile + e_dst
    size = num_tiles * num_edge_types * tile * tile
    flat = _scatter_flat(idx, e_mask, size, dtype)
    return flat.reshape(num_tiles, num_edge_types, tile, tile)


def adj_from_coo_flat(e_tile, e_type, e_src, e_dst, e_mask, num_tiles: int,
                      tile: int, num_edge_types: int = 4,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``adj_from_coo`` in the fused kernel's layout: (P, T, E*T) with
    adj_flat[p, i, e*T + j] = adj[p, e, i, j]."""
    idx = ((e_tile * tile + e_src) * num_edge_types + e_type) * tile + e_dst
    size = num_tiles * tile * num_edge_types * tile
    flat = _scatter_flat(idx, e_mask, size, dtype)
    return flat.reshape(num_tiles, tile, num_edge_types * tile)
