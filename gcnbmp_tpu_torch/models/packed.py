"""Packed-supergraph GGNN pair predictor (port of gcnbmp_tpu/models/packed.py).

Ported pieces:

- ``PackedGatedReadout``            <- :29-41
- ``_segment_mol_sum``              <- :67-87
- ``PackedGGNN``                    <- :147-210 (the plain layer stack)
- ``decode_compact_wire``           <- :918-936
- ``PackedPairPredictorCOOCompact`` <- :939-971; its forward is the fused
  form, ``fused_compact_logits`` (:1176-1212) with the readout fused in
  (:1121-1126): embed -> flat adjacency -> K2 -> segment sum -> left and
  right gather -> HolE.
- ``make_packed_predictor``         <- :1235-1347, the ``method="ggnn"``,
  no co-attention, no layer aggregator, f32 branch;
  ``model_kwargs_from_config`` reads its arguments from a run config.

Parameter names match the flax tree (``encoder/embed``,
``encoder/update_{i}/message/dense``, ``encoder/gru/...``,
``encoder/readout_0/{i,j}``, ``head/mlp/...``).  On CPU tensors the
forward runs the kernels' plain versions; on CUDA tensors it launches
the kernels.  The forward is differentiable end to end: K2's autograd
function carries the gradient (K2b) back to h0, and through the
embedding gather and ``params_to_fused``'s re-layout (stack, transpose,
summed GRU biases) to the module's own parameters; a tied message
function, stacked L times, gets the sum over the layers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models.ggnn import GGNNMessage
from gcnbmp_tpu_torch.models.heads import make_head
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM,
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
)
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat
from gcnbmp_tpu_torch.ops.fused_ggnn import fused_ggnn_readout, params_to_fused


class PackedGatedReadout(nn.Module):
    """Node-level sigmoid(i([h, h0])) * j(h), masked; the molecule sums
    happen outside in ``_segment_mol_sum``."""

    def __init__(self, hidden_dim: int, out_dim: int, device=None):
        super().__init__()
        self.i = GraphLinear(2 * hidden_dim, out_dim, device=device)
        self.j = GraphLinear(hidden_dim, out_dim, device=device)

    def forward(self, h, h0, node_mask):
        gate = torch.sigmoid(self.i(torch.cat([h, h0], dim=-1)))
        return gate * self.j(h) * node_mask[..., None]


def _segment_mol_sum(g_nodes: torch.Tensor, mol_id: torch.Tensor,
                     num_mols: int) -> torch.Tensor:
    """Per-molecule sums of per-node values.  Padding slots carry
    mol_id == num_mols: they are summed into an extra row, dropped."""
    flat = g_nodes.reshape(-1, g_nodes.shape[-1])
    out = torch.zeros(num_mols + 1, flat.shape[-1], dtype=flat.dtype,
                      device=flat.device)
    out.index_add_(0, mol_id.reshape(-1).long(), flat)
    return out[:num_mols]


class PackedGGNN(nn.Module):
    """GGNN encoder over packed tiles.  ``forward`` is the plain layer
    stack of the JAX module (dense (P, 4, T, T) adjacency); the serving
    forward reads these weights through ``params_to_fused`` instead.

    Untied configs have one message function per layer and ONE shared
    GRU, as in the JAX module."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM, weight_tying: bool = True,
                 device=None):
        super().__init__()
        self.out_dim = out_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(hidden_dim, device=device))
        self.gru = ChainerGRUCell(2 * hidden_dim, hidden_dim, device=device)
        self.readout_0 = PackedGatedReadout(hidden_dim, out_dim, device=device)

    def message(self, layer: int) -> GGNNMessage:
        return getattr(self, f"update_{0 if self.weight_tying else layer}")

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        h0 = h
        state = torch.zeros_like(h)
        for step in range(self.n_layers):
            m = self.message(step)(h, adj)
            state = self.gru(state, torch.cat([h, m], dim=-1))
            h = state
        g_nodes = self.readout_0(h, h0, node_mask)
        return _segment_mol_sum(g_nodes, mol_id, num_mols), {"atoms": h, "h0": h0}


def decode_compact_wire(nodes, e_packed, n_edges, num_mols: int):
    """Decode the wire-compact batch (``data.wire.compact_coo_arrays``)
    into (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
    e_mask).  Lane masks use (1 << sbits) - 1 with sbits from T."""
    atom_ids, mol_id = nodes[0], nodes[1]
    t = atom_ids.shape[1]
    sbits = int(t - 1).bit_length()
    lane = (1 << sbits) - 1
    node_mask = (mol_id < num_mols).float()
    e_dst = e_packed & lane
    e_src = (e_packed >> sbits) & lane
    e_type = (e_packed >> (2 * sbits)) & 3
    e_tile = e_packed >> (2 * sbits + 2)
    e_mask = (torch.arange(e_packed.shape[0], device=e_packed.device)
              < n_edges).float()
    return atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst, e_mask


class PackedPairPredictorCOOCompact(nn.Module):
    """Pair predictor over the wire-compact COO batch: (nodes (2, P, T),
    e_packed (E,), n_edges (), left_index (B,), right_index (B,)) ->
    logits (B, C), and with ``return_g`` the pair's embeddings."""

    def __init__(self, encoder: PackedGGNN, head: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.head = head

    def forward(self, nodes, e_packed, n_edges, left_index, right_index,
                return_g: bool = False):
        enc = self.encoder
        num_mols = 2 * left_index.shape[0]
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = decode_compact_wire(nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj_flat = adj_from_coo_flat(e_tile, e_type, e_src, e_dst, e_mask,
                                     num_tiles=p, tile=t)
        h0 = enc.embed(atom_ids)
        msg_w, msg_b, gru = params_to_fused(enc)
        ro = enc.readout_0
        g_nodes = fused_ggnn_readout(
            enc.n_layers, h0, adj_flat, msg_w, msg_b, gru, node_mask,
            ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
            ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        g1 = g[left_index.long()]
        g2 = g[right_index.long()]
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


# Model fields of a run config and the values the port builds.
# compute_path is not read: the packed and padded parameter trees are the
# same, and the port always runs the packed fused form.  compute_dtype is
# a training knob (the trainer rejects bfloat16); serving runs in f32, as
# the JAX packed evaluator does.
_REQUIRED = {
    "method": "ggnn",
    "sim_method": "hole",
    "attn": None,
    "layer_aggregator": None,
    "siamese": True,
    "symmetric": None,
    "concat_hidden": False,
    "fp_batch_normalization": False,
    "fp_dropout_rate": 0.0,
}
# TrainConfig defaults for fields a config.json may omit (the ported
# values above are TrainConfig's defaults as well)
_DEFAULTS = {
    **_REQUIRED, "fp_hidden_dim": 16, "fp_out_dim": 16, "conv_layers": 4,
    "weight_tying": True, "net_hidden_dims": (), "class_num": 1,
}


def model_kwargs_from_config(cfg: dict) -> dict:
    """``make_packed_predictor`` kwargs from a run config dict (a
    ``config.json``, the port's or a JAX run's); raises ValueError on any
    model value outside what the port builds."""
    get = lambda k: cfg.get(k, _DEFAULTS[k])
    bad = [f"{k}={get(k)!r} (ported: {v!r})" for k, v in _REQUIRED.items()
           if get(k) != v]
    if bad:
        raise ValueError("config outside the ported model: "
                         + ", ".join(bad))
    return {
        "fp_hidden_dim": int(get("fp_hidden_dim")),
        "fp_out_dim": int(get("fp_out_dim")),
        "conv_layers": int(get("conv_layers")),
        "weight_tying": bool(get("weight_tying")),
        "sim_method": "hole",
        "class_num": int(get("class_num")),
        "net_hidden_dims": tuple(get("net_hidden_dims") or ()),
    }


def make_packed_predictor(
    fp_hidden_dim: int = 32,
    fp_out_dim: int = 32,
    conv_layers: int = 8,
    weight_tying: bool = True,
    sim_method: str = "hole",
    class_num: int = 1,
    net_hidden_dims: Sequence[int] = (),
    attn: Optional[str] = None,
    method: str = "ggnn",
    layer_aggregator: Optional[str] = None,
    device=None,
) -> PackedPairPredictorCOOCompact:
    """The wire-compact GGNN pair predictor of the JAX package's
    ``make_packed_predictor(..., compact=True)`` for the flagship family."""
    if method != "ggnn":
        raise ValueError(
            f"method {method!r} is not ported yet: the other packed encoders "
            "come later (ROADMAP queue 1, item 9)")
    if attn is not None:
        raise ValueError("co-attention is not ported yet "
                         "(ROADMAP queue 1, item 8)")
    if layer_aggregator is not None:
        raise ValueError("layer_aggregator is not ported yet "
                         "(ROADMAP queue 1, item 9)")
    encoder = PackedGGNN(out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
                         n_layers=conv_layers, weight_tying=weight_tying,
                         device=device)
    head = make_head(sim_method, fp_out_dim, class_num,
                     tuple(net_hidden_dims), device=device)
    return PackedPairPredictorCOOCompact(encoder, head)
