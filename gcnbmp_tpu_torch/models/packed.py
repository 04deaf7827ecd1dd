"""Packed-supergraph pair predictors (port of gcnbmp_tpu/models/packed.py).

Ported pieces:

- ``PackedGatedReadout``            <- :29-41
- ``PackedCommonReadout``           <- :44-65
- ``_segment_mol_sum``              <- :67-87
- ``segment_softmax``               <- :332-340 (GWM's attention)
- ``PackedGGNN``                    <- :147-210 (the plain layer stack, and
  with ``layer_aggregator`` the jumping-knowledge branch :186-210); its
  kernel path ``fused_forward`` is ``_fused_encoder_g_nodes`` (:1102-1133)
  of ``fused_compact_logits`` (:1176-1212) in either form that
  ``FUSED_READOUT`` picks -> segment sum
- ``PackedRelGCN``                  <- :213-246
- ``PackedGIN``                     <- :249-285
- ``PackedNFPReadout``              <- :288-300
- ``PackedNFP``                     <- :818-853
- ``PackedSet2Set``                 <- :343-430, the dense mode
- ``_device_slot_table``            <- :433-455
- ``PackedMPNNReadout``             <- :458-478
- ``PackedEdgeNet``                 <- :531-613, the default ``dotgen`` form
- ``PackedMPNN``                    <- :669-815, EdgeNet or ``ggnn``
  messages, the Set2Set or ``ggnn`` readout; its kernel path
  ``fused_forward`` is the JAX module's fused branch (:717-774): K5 ->
  slot table -> K4 -> linear1, relu, linear2 (or K5 -> the common
  readout -> segment sum), with K5's h for co-attention
- ``decode_compact_wire``           <- :918-936
- ``PackedPairPredictorCOOCompact`` <- :939-971: the encoder's ``encode``
  on the decoded edges -> left and right gather -> the head
- ``PackedCoattnPairPredictor``     <- :974-1033: ``encode`` with the
  per-atom states -> per-pair atom tables -> co-attention -> the head
- ``make_packed_predictor``         <- :1235-1347, every packed encoder
  (GGNN with or without a layer aggregator, MPNN, RelGCN, GIN, NFP, and
  GGNN-GWM from ``models.gwm``) with every head, co-attention over every
  encoder but GWM; ``model_kwargs_from_config`` reads its
  arguments from a run config.

Every encoder has ``encode(atom_ids, edges, mol_id, node_mask, num_mols,
return_atoms=False)``, the one method the predictors call: it builds the
adjacency layout the encoder needs from the decoded COO edges.  GGNN
(without an aggregator) and MPNN build the kernels' flat (P, T, 4T)
layout and run their kernel paths; RelGCN, GIN, NFP and GGNN with a layer
aggregator build the dense (P, 4, T, T) adjacency and run their plain
stacks (``DenseAdjacencyEncoder``).  The JAX package has no Pallas kernel for any of those four (its
trainer runs them as XLA ops on ``coo`` and refuses ``fused``), so the
port runs them as PyTorch ops on the card: the same design, not a
fallback.  The GGNN kernels keep no per-layer states (K1 has no
layer-range forward), which is why the aggregator takes the plain stack.

Parameter names match the flax trees (``encoder/embed``,
``encoder/update_{i}/message/dense``, ``encoder/gru/...``,
``encoder/readout_0/{i,j}`` for GGNN, ``encoder/layer_aggregator/...`` and
``encoder/readout_agg/{i,j}`` with an aggregator; ``encoder/conv_{i}/
{self,edge}``, ``encoder/readout/{i,j}`` for RelGCN;
``encoder/update_{i}/linear_g{1,2}``, ``encoder/readout_0/{i,j}`` for GIN;
``encoder/update_{i}/linear_d{d}``, ``encoder/readout_{i}/output_weight``
for NFP; ``encoder/message_{i}/nn1|nn2``,
``encoder/gru_{i}/...``, ``encoder/readout_0/set2set/lstm/...``,
``encoder/readout_0/linear1|linear2`` for MPNN; ``head/...``;
``coattention/...``, see ``models.coattention``).  On
CPU tensors the kernel paths run the kernels' plain versions; on CUDA
tensors they launch the kernels.  They are differentiable end to end: the
kernels' autograd functions carry the gradient back to h0, and through the
embedding gather and the weight re-layouts (``params_to_fused``,
``params_to_fused_mpnn``: stacks, transposes, summed GRU biases) to the
modules' own parameters; a tied layer, stacked L times, gets the sum over
the layers.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from gcnbmp_tpu_torch.models import ggnn_extras
from gcnbmp_tpu_torch.models.coattention import (
    COATTENTION_REGISTRY, build_coattention)
from gcnbmp_tpu_torch.models.ggnn import NUM_EDGE_TYPE, GGNNMessage
from gcnbmp_tpu_torch.models.gin import GINUpdate
from gcnbmp_tpu_torch.models.heads import HEADS, make_head
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM,
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
    OptimizedLSTMCell,
)
from gcnbmp_tpu_torch.models.nfp import NFPUpdate
from gcnbmp_tpu_torch.models.relgcn import RelGCNUpdate, rescale_adj
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo, adj_from_coo_flat
from gcnbmp_tpu_torch.ops.fused_ggnn import (
    fused_ggnn, fused_ggnn_readout, params_to_fused)
from gcnbmp_tpu_torch.ops.fused_mpnn import fused_mpnn, params_to_fused_mpnn
from gcnbmp_tpu_torch.ops.set2set_kernel import NEG, fused_set2set
from gcnbmp_tpu_torch.ops.slotgather import (
    gather_slot_table, identity_mol_row, side_mol_row)


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


class PackedCommonReadout(nn.Module):
    """Node-level sigmoid(i(x)) * activation(j(x)), masked, with x =
    [h, h0], or h alone when the caller passes h0=None; ``in_features`` is
    x's width.  ``nobias`` drops both biases."""

    def __init__(self, in_features: int, out_dim: int, nobias: bool = False,
                 activation=None, device=None):
        super().__init__()
        self.activation = activation
        self.i = GraphLinear(in_features, out_dim, bias=not nobias,
                             device=device)
        self.j = GraphLinear(in_features, out_dim, bias=not nobias,
                             device=device)

    def forward(self, h, h0, node_mask):
        x = h if h0 is None else torch.cat([h, h0], dim=-1)
        value = self.j(x)
        if self.activation is not None:
            value = self.activation(value)
        return torch.sigmoid(self.i(x)) * value * node_mask[..., None]


class PackedNFPReadout(nn.Module):
    """Node-level softmax over channels of ``output_weight(h)``, masked;
    the molecule sums happen outside."""

    def __init__(self, in_features: int, out_dim: int, device=None):
        super().__init__()
        self.output_weight = GraphLinear(in_features, out_dim, device=device)

    def forward(self, h, node_mask):
        return torch.softmax(self.output_weight(h), dim=-1) * node_mask[..., None]


def segment_softmax(scores: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax of ``scores`` (N, K) over the rows of each segment
    (``ids`` (N,)); invalid rows (``valid`` 0) get score -1e9 and weight
    0, and a segment's denominator is clamped at 1e-9, so a segment
    without a valid row (the pad segment, an empty molecule) weighs 0,
    not NaN.  The shift by each segment's max is taken without gradient:
    the softmax does not depend on it, so its gradient is the softmax's
    own, which the JAX function's (through ``segment_max``) equals up to
    rounding."""
    ids = ids.long()
    masked = torch.where(valid[:, None] > 0, scores,
                         torch.full_like(scores, -1e9))
    with torch.no_grad():
        # segments that receive no row keep 0 (include_self=False)
        m = masked.new_zeros((num_segments, scores.shape[1])).scatter_reduce(
            0, ids[:, None].expand_as(masked), masked, "amax",
            include_self=False)
    e = torch.exp(masked - m[ids]) * valid[:, None]
    s = e.new_zeros((num_segments, scores.shape[1])).index_add_(0, ids, e)
    return e / torch.clamp(s[ids], min=1e-9)


def _segment_mol_sum(g_nodes: torch.Tensor, mol_id: torch.Tensor,
                     num_mols: int) -> torch.Tensor:
    """Per-molecule sums of per-node values.  Padding slots carry
    mol_id == num_mols: they are summed into an extra row, dropped."""
    flat = g_nodes.reshape(-1, g_nodes.shape[-1])
    out = torch.zeros(num_mols + 1, flat.shape[-1], dtype=flat.dtype,
                      device=flat.device)
    out.index_add_(0, mol_id.reshape(-1).long(), flat)
    return out[:num_mols]


# The GGNN kernel path's form, the JAX module's ``FUSED_READOUT``
# (GCNBMP_FUSED_READOUT), read by ``PackedGGNN.fused_forward`` per call:
# "1" runs the gated readout inside the kernel, K2 (K2b in the backward);
# "0" runs the JAX package's default form, K1 (K1b, or K1m and K3 under
# ``ops.fused_ggnn.TWOPASS``) with ``PackedGatedReadout`` in plain torch
# after it.  Unset, the port keeps K2, where the JAX package defaults to
# the other form: the TPU left K2 off only because K2b's 8-layer backward
# did not compile there (ROADMAP queue 2, K2 note).  Both forms compute
# the same function; the tests hold both against JAX.  K2 is built for a
# readout width D equal to the hidden width H: a GGNN with D != H takes
# the JAX default form whatever the flag says.
FUSED_READOUT = os.environ.get("GCNBMP_FUSED_READOUT", "1") == "1"


def readout_in_kernel(hidden_dim: Optional[int] = None,
                      out_dim: Optional[int] = None) -> bool:
    """Whether the GGNN kernel path runs K2/K2b for these widths."""
    return FUSED_READOUT and hidden_dim == out_dim


def fused_form(hidden_dim: Optional[int] = None,
               out_dim: Optional[int] = None,
               attn: Optional[str] = None,
               layer_aggregator: Optional[str] = None) -> str:
    """The kernels the GGNN kernel path runs under the current flags for
    a model of these widths (unnamed widths: D = H); a co-attention model
    (``attn``) needs the per-atom states, which K2 does not write, so it
    always takes the K1 form.  A layer aggregator needs every layer's
    states, which no kernel keeps: that model runs the plain stack."""
    from gcnbmp_tpu_torch.ops import fused_ggnn as fg

    if layer_aggregator is not None:
        return (f"none: the layer aggregator ({layer_aggregator}) reads "
                "every layer's states, so the plain layer stack runs")
    if attn is None and readout_in_kernel(hidden_dim, out_dim):
        return "K2/K2b (gated readout in the kernel)"
    if fg.TWOPASS:
        return "K1m/K3 (two-pass backward) + plain readout"
    return "K1/K1b + plain readout"


class DenseAdjacencyEncoder(nn.Module):
    """An encoder whose ``encode`` runs its plain stack, ``forward``, on
    the dense (P, 4, T, T) adjacency built from the COO edges: RelGCN,
    GIN, NFP, and GGNN with a layer aggregator."""

    def encode(self, atom_ids, edges, mol_id, node_mask, num_mols: int,
               return_atoms: bool = False):
        """Per-molecule embeddings (num_mols, D) from the decoded edges
        (e_tile, e_type, e_src, e_dst, e_mask); ``return_atoms``: also
        the last layer's per-atom states."""
        p, t = atom_ids.shape
        adj = adj_from_coo(*edges, num_tiles=p, tile=t)
        g, aux = self(atom_ids, adj, mol_id, node_mask, num_mols)
        return (g, aux["atoms"]) if return_atoms else g


class PackedGGNN(DenseAdjacencyEncoder):
    """GGNN encoder over packed tiles.  ``forward`` is the plain layer
    stack of the JAX module (dense (P, 4, T, T) adjacency);
    ``fused_forward``, which ``encode`` (the predictors' path) runs,
    reads these weights through ``params_to_fused`` into the kernels, in
    the form ``FUSED_READOUT`` picks.

    Untied configs have one message function per layer and ONE shared
    GRU, as in the JAX module.  With ``layer_aggregator`` (a mode of
    ``models.ggnn_extras``) the readout is ``readout_agg`` over the
    aggregated states of every layer, and ``encode`` runs the plain
    stack: the kernels keep no per-layer states."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM, weight_tying: bool = True,
                 layer_aggregator: Optional[str] = None, device=None):
        super().__init__()
        self.out_dim = out_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(hidden_dim, device=device))
        self.gru = ChainerGRUCell(2 * hidden_dim, hidden_dim, device=device)
        if layer_aggregator is None:
            self.layer_aggregator = None
            self.readout_0 = PackedGatedReadout(hidden_dim, out_dim,
                                                device=device)
        else:
            self.layer_aggregator = ggnn_extras.LayerAggregator(
                layer_aggregator, hidden_dim, n_layers, device=device)
            self.readout_agg = PackedGatedReadout(
                ggnn_extras.aggregated_width(layer_aggregator, hidden_dim,
                                             n_layers), out_dim, device=device)

    def message(self, layer: int) -> GGNNMessage:
        return getattr(self, f"update_{0 if self.weight_tying else layer}")

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        h0 = h
        state = torch.zeros_like(h)
        h_list = []
        for step in range(self.n_layers):
            m = self.message(step)(h, adj)
            state = self.gru(state, torch.cat([h, m], dim=-1))
            h = state
            h_list.append(h)
        if self.layer_aggregator is None:
            g_nodes = self.readout_0(h, h0, node_mask)
        else:
            g_nodes = self.readout_agg(*self.layer_aggregator(h_list, h0),
                                       node_mask)
        return _segment_mol_sum(g_nodes, mol_id, num_mols), {"atoms": h, "h0": h0}

    def encode(self, atom_ids, edges, mol_id, node_mask, num_mols: int,
               return_atoms: bool = False):
        """The predictors' entry: ``fused_forward`` on the flat adjacency
        built from ``edges`` (e_tile, e_type, e_src, e_dst, e_mask), or
        with a layer aggregator the plain stack on the dense one."""
        if self.layer_aggregator is not None:
            return super().encode(atom_ids, edges, mol_id, node_mask,
                                  num_mols, return_atoms)
        p, t = atom_ids.shape
        adj_flat = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
        return self.fused_forward(atom_ids, adj_flat, mol_id, node_mask,
                                  num_mols, return_atoms=return_atoms)

    def fused_forward(self, atom_ids, adj_flat, mol_id, node_mask,
                      num_mols: int, return_atoms: bool = False):
        """Per-molecule embeddings (num_mols, D) from the flat (P, T, 4T)
        adjacency: through K2 (K2b in the backward), or K1 and the plain
        readout (K1b, or K3 twice, in the backward), by ``FUSED_READOUT``
        and the widths (``readout_in_kernel``).  ``return_atoms``: also
        return the last layer's per-atom states h (P, T, H), for which the
        path always takes the K1 form (K2 writes no h); h then feeds the
        readout and the caller, and the backward takes the sum of both
        gradients."""
        h0 = self.embed(atom_ids)
        msg_w, msg_b, gru = params_to_fused(self)
        ro = self.readout_0
        h = None
        if not return_atoms and readout_in_kernel(self.hidden_dim,
                                                  self.out_dim):
            g_nodes = fused_ggnn_readout(
                self.n_layers, h0, adj_flat, msg_w, msg_b, gru, node_mask,
                ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
        else:
            h = fused_ggnn(self.n_layers, h0, adj_flat, msg_w, msg_b, gru)
            g_nodes = ro(h, h0, node_mask)
        g = _segment_mol_sum(g_nodes, mol_id, num_mols)
        return (g, h) if return_atoms else g


class PackedRelGCN(DenseAdjacencyEncoder):
    """RelGCN encoder over packed tiles: ``embed``, then per layer
    tanh(``conv_{i}``), then ``readout`` (``PackedCommonReadout`` over h
    alone, no biases, tanh) summed per molecule.  The channel list is
    [hidden] * (n_layers + 1), as the JAX factory builds it; ``scale_adj``
    divides the adjacency by each atom's in-degree first."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 2,
                 n_atom_types: int = MAX_ATOMIC_NUM, scale_adj: bool = False,
                 device=None):
        super().__init__()
        self.scale_adj = scale_adj
        self.n_layers = n_layers
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(n_layers):
            self.add_module(f"conv_{i}", RelGCNUpdate(hidden_dim, hidden_dim,
                                                      device=device))
        self.readout = PackedCommonReadout(hidden_dim, out_dim, nobias=True,
                                           activation=torch.tanh,
                                           device=device)

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        if self.scale_adj:
            adj = rescale_adj(adj)
        for i in range(self.n_layers):
            h = torch.tanh(getattr(self, f"conv_{i}")(h, adj))
        g_nodes = self.readout(h, None, node_mask)
        return _segment_mol_sum(g_nodes, mol_id, num_mols), {"atoms": h, "h0": None}


class PackedGIN(DenseAdjacencyEncoder):
    """GIN encoder over packed tiles: ``embed``, the ``update_{i}`` layers
    (one shared under weight tying, applied n_layers times), then
    ``readout_0`` (``PackedCommonReadout`` over [h, h0]) summed per
    molecule.  Deterministic: the trainer refuses dropout."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM, weight_tying: bool = True,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GINUpdate(hidden_dim, device=device))
        self.readout_0 = PackedCommonReadout(2 * hidden_dim, out_dim,
                                             device=device)

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        h0 = h
        for step in range(self.n_layers):
            h = getattr(self, f"update_{0 if self.weight_tying else step}")(
                h, adj)
        g_nodes = self.readout_0(h, h0, node_mask)
        return _segment_mol_sum(g_nodes, mol_id, num_mols), {"atoms": h, "h0": h0}


class PackedNFP(DenseAdjacencyEncoder):
    """NFP encoder over packed tiles: the plain adjacency is the edge
    types' sum clipped to [0, 1] plus self-loops on real slots only; each
    atom's integer degree counts its self-loop; per layer ``update_{i}``
    (degree-conditioned linears, sigmoid) and its own ``readout_{i}``
    (``PackedNFPReadout``), the molecule sums added over the layers."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 max_degree: int = 6, n_atom_types: int = MAX_ATOMIC_NUM,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(n_layers):
            self.add_module(f"update_{i}", NFPUpdate(
                hidden_dim, hidden_dim, max_degree, device=device))
            self.add_module(f"readout_{i}", PackedNFPReadout(
                hidden_dim, out_dim, device=device))

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        plain = adj.sum(dim=1).clamp(0.0, 1.0)
        t = plain.shape[-1]
        eye = torch.eye(t, dtype=plain.dtype, device=plain.device)[None]
        plain = plain + eye * node_mask[:, :, None] * node_mask[:, None, :]
        deg = plain.sum(dim=1).to(torch.int32)
        g = 0.0
        for i in range(self.n_layers):
            h = getattr(self, f"update_{i}")(h, plain, deg)
            per = getattr(self, f"readout_{i}")(h, node_mask)
            g = g + _segment_mol_sum(per, mol_id, num_mols)
        return g, {"atoms": h, "h0": None}


def _device_slot_table(ids: torch.Tensor, valid: torch.Tensor, num_mols: int,
                       n_max: int):
    """Each molecule's flat slot indices (num_mols, n_max) and mask, from
    the packed layout's invariant that a molecule occupies a contiguous
    run of flat slots: start = the run's smallest position, count = its
    real slots.  Molecules with no atoms (pair padding) get an all-zero
    mask.  Also returns ``overflow``, a device flag set when a molecule
    has more atoms than n_max."""
    n = ids.shape[0]
    ids = ids.long()
    pos = torch.arange(n, device=ids.device)
    starts = torch.full((num_mols + 1,), n, dtype=torch.long,
                        device=ids.device).scatter_reduce(
        0, ids, pos, "amin", include_self=True)[:num_mols]
    counts = torch.zeros(num_mols + 1, dtype=valid.dtype,
                         device=ids.device).index_add_(0, ids, valid)[:num_mols]
    j = torch.arange(n_max, device=ids.device)[None, :]
    slots = (starts[:, None] + j).clamp(0, n - 1)
    amask = (j < counts[:, None]).to(valid.dtype)
    return slots, amask, (counts > n_max).any()


# Set2Set processing steps of the MPNN readout (the JAX module's default;
# not a config field)
SET2SET_STEPS = 3


class PackedSet2Set(nn.Module):
    """Set2Set readout over the packed layout, the JAX module's dense mode:
    each molecule's atoms are gathered once into a (num_mols, n_max, C)
    table (``_device_slot_table``, ``gather_slot_table``), then every
    step is an LSTM, a masked softmax over the table and a weighted sum.
    ``forward(..., fused=True)`` runs all steps in K4 (K4b in the
    backward).  A molecule wider than ``dense_n_max`` turns the whole
    output NaN, as in the JAX module."""

    def __init__(self, channels: int, processing_steps: int = SET2SET_STEPS,
                 dense_n_max: int = 64, device=None):
        super().__init__()
        self.channels = channels
        self.processing_steps = processing_steps
        self.dense_n_max = dense_n_max
        self.lstm = OptimizedLSTMCell(2 * channels, channels, device=device)

    def forward(self, h, mol_id, node_mask, num_mols: int,
                fused: bool = False) -> torch.Tensor:
        ch = h.shape[-1]
        flat = h.reshape(-1, ch)
        ids = mol_id.reshape(-1)
        slots, amask, overflow = _device_slot_table(
            ids, node_mask.reshape(-1), num_mols, self.dense_n_max)
        atoms = gather_slot_table(flat, slots, amask, ids,
                                  identity_mol_row(num_mols, h.device))
        if fused:
            q_star = fused_set2set(self.processing_steps, atoms, amask,
                                   *self.lstm.kernels())
        else:
            c = h.new_zeros((num_mols, self.channels))
            hh = h.new_zeros((num_mols, self.channels))
            q_star = h.new_zeros((num_mols, 2 * ch))
            for _ in range(self.processing_steps):
                (c, hh), q = self.lstm((c, hh), q_star)
                e = torch.einsum("mnc,mc->mn", atoms, q)
                e = torch.where(amask > 0, e, torch.full_like(e, NEG))
                a = torch.softmax(e, dim=1) * amask
                r = torch.einsum("mn,mnc->mc", a, atoms)
                q_star = torch.cat([q, r], dim=-1)
        return torch.where(overflow, torch.full_like(q_star, float("nan")),
                           q_star)


class PackedMPNNReadout(nn.Module):
    """Set2Set, then ``linear1`` -> relu -> ``linear2``; returns
    per-molecule vectors (num_mols, out_dim)."""

    def __init__(self, out_dim: int, hidden_dim: int,
                 processing_steps: int = SET2SET_STEPS, s2s_n_max: int = 64,
                 device=None):
        super().__init__()
        self.set2set = PackedSet2Set(hidden_dim, processing_steps, s2s_n_max,
                                     device=device)
        self.linear1 = nn.Linear(2 * hidden_dim, hidden_dim, device=device)
        self.linear2 = nn.Linear(hidden_dim, out_dim, device=device)

    def forward(self, h, mol_id, node_mask, num_mols: int,
                fused: bool = False) -> torch.Tensor:
        g = self.set2set(h, mol_id, node_mask, num_mols, fused)
        return self.linear2(torch.relu(self.linear1(g)))


class PackedEdgeNet(nn.Module):
    """EdgeNet message over packed tiles, the JAX module's ``dotgen``
    form: per-edge-type matrices M_e and the non-edge matrix M0 come from
    ``nn1``/``nn2`` applied to the basis [0; I_4]; the message is
    [out + bg, in + bg] with out/in the two directions of
    sum_e A_e (h (M_e - M0)^T) over the raw (P, 4, T, T) adjacency and
    bg = M0 times the per-molecule sum of real-node h."""

    def __init__(self, out_channels: int, edge_hidden_dim: int = 16,
                 device=None):
        super().__init__()
        self.out_channels = out_channels
        self.nn1 = nn.Linear(NUM_EDGE_TYPE, edge_hidden_dim, device=device)
        self.nn2 = nn.Linear(edge_hidden_dim, out_channels * out_channels,
                             device=device)

    def matrices(self):
        """(M0 (C, C), M_e (4, C, C))."""
        w = self.nn1.weight
        basis = torch.cat([w.new_zeros((1, NUM_EDGE_TYPE)),
                           torch.eye(NUM_EDGE_TYPE, dtype=w.dtype,
                                     device=w.device)])
        ch = self.out_channels
        mats = self.nn2(torch.relu(self.nn1(basis))).reshape(5, ch, ch)
        return mats[0], mats[1:]

    def forward(self, h, adj, mol_id, node_mask, num_mols: int):
        ch = h.shape[-1]
        m0, m_types = self.matrices()
        ids = mol_id.long()
        mol_sum = h.new_zeros((num_mols + 1, ch)).index_add_(
            0, ids.reshape(-1), (h * node_mask[..., None]).reshape(-1, ch))
        bg = (mol_sum @ m0.T)[ids]                        # zero on pad slots
        hm = torch.einsum("tcd,pjd->ptjc", m_types - m0, h)  # (P, 4, T, C)
        out = torch.einsum("peij,pejc->pic", adj, hm)
        inn = torch.einsum("peij,peic->pjc", adj, hm)
        return torch.cat([out + bg, inn + bg], dim=-1)


class PackedMPNN(nn.Module):
    """MPNN encoder over packed tiles: EdgeNet messages (``message_func=
    'ggnn'``: a ``GGNNMessage``, the GRU reading [h ‖ m]), a GRU per layer
    and the Set2Set readout (``readout_func='ggnn'``: a
    ``PackedCommonReadout`` over [h ‖ h0], summed per molecule).  Weight
    tying shares ONE message function and ONE GRU, whose state carries
    across the layers; untied layers each have their own and restart from
    a zero state, as in the JAX module.  The tree is the padded ``MPNN``'s,
    so checkpoints swap between the layouts.  ``forward`` is the plain
    layer stack (dense adjacency); ``fused_forward``, the predictors' path
    for EdgeNet, runs K5, then K4 for the Set2Set readout."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM, weight_tying: bool = True,
                 message_func: str = "edgenet", readout_func: str = "set2set",
                 edge_hidden_dim: int = 16, s2s_n_max: int = 64, device=None):
        super().__init__()
        if message_func not in ("edgenet", "ggnn"):
            raise ValueError(f"invalid message function {message_func!r}")
        if readout_func not in ("set2set", "ggnn"):
            raise ValueError(f"invalid readout function {readout_func!r}")
        self.out_dim = out_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.message_func = message_func
        self.readout_func = readout_func
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"message_{i}", PackedEdgeNet(
                hidden_dim, edge_hidden_dim, device=device)
                if message_func == "edgenet" else
                GGNNMessage(hidden_dim, device=device))
            self.add_module(f"gru_{i}", ChainerGRUCell(
                2 * hidden_dim, hidden_dim, device=device))
        self.readout_0 = (
            PackedMPNNReadout(out_dim, hidden_dim, s2s_n_max=s2s_n_max,
                              device=device)
            if readout_func == "set2set" else
            PackedCommonReadout(2 * hidden_dim, out_dim, device=device))

    def message(self, layer: int) -> nn.Module:
        return getattr(self, f"message_{0 if self.weight_tying else layer}")

    def gru(self, layer: int) -> ChainerGRUCell:
        return getattr(self, f"gru_{0 if self.weight_tying else layer}")

    def _readout(self, h, h0, mol_id, node_mask, num_mols: int,
                 fused: bool) -> torch.Tensor:
        """Per-molecule vectors: the Set2Set readout (K4 when ``fused``),
        or the common readout's node values summed per molecule."""
        if self.readout_func == "ggnn":
            return _segment_mol_sum(self.readout_0(h, h0, node_mask), mol_id,
                                    num_mols)
        return self.readout_0(h, mol_id, node_mask, num_mols, fused)

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int,
                fused_readout: bool = False):
        h = self.embed(atom_ids)
        h0 = h
        states = {}
        for step in range(self.n_layers):
            k = 0 if self.weight_tying else step
            msg = self.message(step)
            x = (msg(h, adj, mol_id, node_mask, num_mols)
                 if self.message_func == "edgenet"
                 else torch.cat([h, msg(h, adj)], dim=-1))
            h = self.gru(step)(states.get(k, torch.zeros_like(h)), x)
            states[k] = h
        g = self._readout(h, h0, mol_id, node_mask, num_mols, fused_readout)
        return g, {"atoms": h, "h0": h0}

    def fused_forward(self, atom_ids, adj_flat, mol_id, node_mask,
                      num_mols: int, return_atoms: bool = False):
        """Per-molecule embeddings (num_mols, D) through K5 (K5b in the
        backward), from the flat (P, T, 4T) adjacency, then the readout
        (K4 and K4b for Set2Set).  ``return_atoms``: also return K5's
        per-atom states h (P, T, H); h then feeds the readout and the
        caller, and K5b takes the sum of both gradients."""
        h0 = self.embed(atom_ids)
        wt, m0t, gru = params_to_fused_mpnn(self)
        h = fused_mpnn(self.n_layers, self.weight_tying, h0, adj_flat,
                       mol_id.to(torch.int32).contiguous(), node_mask, wt,
                       m0t, gru)
        g = self._readout(h, h0, mol_id, node_mask, num_mols, fused=True)
        return (g, h) if return_atoms else g

    def encode(self, atom_ids, edges, mol_id, node_mask, num_mols: int,
               return_atoms: bool = False):
        """The predictors' entry: ``fused_forward`` on the flat adjacency
        built from ``edges``.  The kernel holds EdgeNet only, as JAX's
        fused branch does (packed.py:717): the ``ggnn`` message runs the
        plain stack on the dense adjacency, and its Set2Set readout K4, as
        the JAX readout runs its Pallas kernel after either message."""
        p, t = atom_ids.shape
        if self.message_func == "ggnn":
            adj = adj_from_coo(*edges, num_tiles=p, tile=t)
            g, aux = self(atom_ids, adj, mol_id, node_mask, num_mols,
                          fused_readout=True)
            return (g, aux["atoms"]) if return_atoms else g
        adj_flat = adj_from_coo_flat(*edges, num_tiles=p, tile=t)
        return self.fused_forward(atom_ids, adj_flat, mol_id, node_mask,
                                  num_mols, return_atoms=return_atoms)


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


def pair_logits(head: nn.Module, g: torch.Tensor, left_index, right_index,
                return_g: bool = False):
    """The head over each pair's two molecule embeddings, gathered from
    g (num_mols, D); with ``return_g`` also the two embeddings."""
    g1 = g[left_index.long()]
    g2 = g[right_index.long()]
    logits = head(g1, g2)
    return (logits, g1, g2) if return_g else logits


class PackedPairPredictorCOOCompact(nn.Module):
    """Pair predictor over the wire-compact COO batch: (nodes (2, P, T),
    e_packed (E,), n_edges (), left_index (B,), right_index (B,)) ->
    logits (B, C), and with ``return_g`` the pair's embeddings."""

    def __init__(self, encoder: nn.Module, head: nn.Module):
        super().__init__()
        self.encoder = encoder  # any packed encoder (its ``encode``)
        self.head = head

    def wire_encoder(self, datasets=(), n_max: Optional[int] = None):
        """The host encoder of this predictor's batches:
        ``data.wire.compact_coo_arrays`` (it needs no atom table width)."""
        from gcnbmp_tpu_torch.data.wire import compact_coo_arrays

        return compact_coo_arrays

    def forward(self, nodes, e_packed, n_edges, left_index, right_index,
                return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        atom_ids, mol_id, node_mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, num_mols)
        g = self.encoder.encode(atom_ids, edges, mol_id, node_mask, num_mols)
        return pair_logits(self.head, g, left_index, right_index, return_g)


class PackedCoattnPairPredictor(nn.Module):
    """Co-attention pair predictor over the wire-compact batch (JAX
    :974-1033): the encoder's ``encode`` returns g and the last layer's
    per-atom states h (GGNN's kernel path in its K1 form, MPNN's K5
    output); each pair side's atoms are gathered out of the tiles through
    its slot table (``data.wire.compact_coattn_arrays``,
    gather-only backward), then co-attention and the head.  Takes the
    nine wire arrays; with ``return_g`` also the co-attention outputs."""

    def __init__(self, encoder: nn.Module, coattention: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.encoder = encoder  # any packed encoder but GWM
        self.coattention = coattention
        self.head = head

    @property
    def table_width(self) -> Optional[int]:
        """The atom table width the weights fix (``lt``), else None."""
        w1 = getattr(self.coattention, "W1", None)
        return None if w1 is None else int(w1.shape[0])

    def wire_encoder(self, datasets=(), n_max: Optional[int] = None):
        """The host encoder of this predictor's batches:
        ``data.wire.compact_coattn_arrays`` at atom table width ``n_max``,
        by default the largest molecule of ``datasets`` rounded up to 8,
        as the JAX evaluator takes it (evaluate.py:156-162).  A width other
        than the one ``lt``'s weights fix is refused, as flax refuses it
        (ScopeParamShapeError)."""
        import functools

        from gcnbmp_tpu_torch.data.packing import max_atoms_lane_rounded
        from gcnbmp_tpu_torch.data.wire import compact_coattn_arrays

        n_max = n_max or max_atoms_lane_rounded(datasets)
        fixed = self.table_width
        if fixed is not None and fixed != n_max:
            raise ValueError(
                f"the lt co-attention weights hold atom tables {fixed} wide; "
                f"this dataset needs tables {n_max} wide, which the JAX "
                "package cannot serve with these weights either")
        return functools.partial(compact_coattn_arrays, n_max=n_max)

    def forward(self, nodes, e_packed, n_edges, left_index, right_index,
                left_slots, right_slots, left_mask, right_mask,
                return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        atom_ids, mol_id, node_mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, num_mols)
        g, h = self.encoder.encode(atom_ids, edges, mol_id, node_mask,
                                   num_mols, return_atoms=True)
        flat = h.reshape(-1, h.shape[-1])
        ids = mol_id.reshape(-1)
        atoms1 = gather_slot_table(flat, left_slots, left_mask, ids,
                                   side_mol_row(left_index, num_mols))
        atoms2 = gather_slot_table(flat, right_slots, right_mask, ids,
                                   side_mol_row(right_index, num_mols))
        g1, g2 = self.coattention(atoms1, g[left_index.long()], atoms2,
                                  g[right_index.long()], left_mask, right_mask)
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


# Model fields of a run config and the values the port builds.
# compute_path is not read here: the packed and padded parameter trees are
# the same, and every packed layout runs the compact-COO predictor
# (``train.checkpoints.served_predictor`` picks the layout a run is
# served on).
# compute_dtype is a training knob (the trainer takes bfloat16 and
# computes in f32); serving runs in f32, as the JAX packed evaluator
# does.


def _build_encoder(method: str, out_dim: int, hidden_dim: int, n_layers: int,
                   weight_tying: bool, layer_aggregator: Optional[str],
                   s2s_n_max: int, device) -> nn.Module:
    """The packed encoder of ``method``, with the arguments the JAX
    factory passes it (packed.py:1282-1324): RelGCN and NFP take no
    weight tying, only GGNN a layer aggregator; GWM's supernode width is
    its hidden width, with 8 heads."""
    from gcnbmp_tpu_torch.models.gwm import PackedGGNN_GWM

    builders = {
        "ggnn-gwm": lambda: PackedGGNN_GWM(
            out_dim, hidden_dim, hidden_dim_super=hidden_dim,
            n_layers=n_layers, weight_tying=weight_tying, device=device),
        "ggnn": lambda: PackedGGNN(out_dim, hidden_dim, n_layers,
                                   weight_tying=weight_tying,
                                   layer_aggregator=layer_aggregator,
                                   device=device),
        "mpnn": lambda: PackedMPNN(out_dim, hidden_dim, n_layers,
                                   weight_tying=weight_tying,
                                   s2s_n_max=s2s_n_max, device=device),
        "relgcn": lambda: PackedRelGCN(out_dim, hidden_dim, n_layers,
                                       device=device),
        "gin": lambda: PackedGIN(out_dim, hidden_dim, n_layers,
                                 weight_tying=weight_tying, device=device),
        "nfp": lambda: PackedNFP(out_dim, hidden_dim, n_layers,
                                 device=device),
    }
    return builders[method]()


# the JAX package's PACKED_ENCODERS (packed.py:1232)
PORTED_METHODS = ("ggnn", "relgcn", "gin", "nfp", "mpnn")
_REQUIRED = {
    "siamese": True,
    "symmetric": None,
    "concat_hidden": False,
    "fp_batch_normalization": False,
    "fp_dropout_rate": 0.0,
}
# TrainConfig defaults for fields a config.json may omit (the ported
# values above are TrainConfig's defaults as well)
_DEFAULTS = {
    **_REQUIRED, "method": "ggnn", "sim_method": "hole", "attn": None,
    "layer_aggregator": None, "fp_hidden_dim": 16, "fp_out_dim": 16,
    "conv_layers": 4, "weight_tying": True, "net_hidden_dims": (),
    "class_num": 1,
}


def model_problems(method: str, sim_method: str, attn: Optional[str],
                   layer_aggregator: Optional[str] = None) -> list:
    """The encoder, head, co-attention and layer aggregator choices the
    port does not build, each with its reason."""
    bad = []
    if method not in PORTED_METHODS + ("ggnn-gwm",):
        bad.append(f"method={method!r} (the packed encoders: "
                   f"{', '.join(map(repr, PORTED_METHODS))} and "
                   "'ggnn-gwm'; the JAX package builds no other either)")
    if sim_method not in HEADS:
        bad.append(f"sim_method={sim_method!r} (heads: {sorted(HEADS)})")
    if attn is not None:
        if attn not in COATTENTION_REGISTRY:
            bad.append(f"attn={attn!r} (variants: "
                       f"{sorted(COATTENTION_REGISTRY)})")
        elif method == "ggnn-gwm":
            # the JAX factory's refusal (packed.py:1266-1274)
            bad.append(f"attn={attn!r} with method='ggnn-gwm': ggnn-gwm "
                       "rides the dense packed or wire-compact COO layouts, "
                       "without co-attention, as in the JAX package")
    if layer_aggregator is not None:
        if method != "ggnn":
            bad.append(f"layer_aggregator={layer_aggregator!r} with "
                       f"method={method!r}: the layer aggregator rides the "
                       "packed GGNN only, as in the JAX package")
        elif layer_aggregator not in ggnn_extras.MODES:
            bad.append(f"layer_aggregator={layer_aggregator!r} (modes: "
                       f"{', '.join(ggnn_extras.MODES)}; the reference's "
                       "'self-attn' is unfinished)")
    return bad


def model_kwargs_from_config(cfg: dict) -> dict:
    """``make_packed_predictor`` kwargs from a run config dict (a
    ``config.json``, the port's or a JAX run's); raises ValueError on any
    model value outside what the port builds.  The Set2Set and ``lt``
    atom table widths are not config fields: they take
    ``make_packed_predictor``'s default, as the JAX evaluator does, unless
    the caller adds them (``s2s_n_max``, ``coattn_n_max``)."""
    get = lambda k: cfg.get(k, _DEFAULTS[k])
    bad = model_problems(get("method"), get("sim_method"), get("attn"),
                         get("layer_aggregator"))
    bad += [f"{k}={get(k)!r} (ported: {v!r})" for k, v in _REQUIRED.items()
            if get(k) != v]
    if bad:
        raise ValueError("config outside the ported model: "
                         + ", ".join(bad))
    return {
        "method": get("method"),
        "fp_hidden_dim": int(get("fp_hidden_dim")),
        "fp_out_dim": int(get("fp_out_dim")),
        "conv_layers": int(get("conv_layers")),
        "weight_tying": bool(get("weight_tying")),
        "sim_method": get("sim_method"),
        "attn": get("attn"),
        "layer_aggregator": get("layer_aggregator"),
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
    s2s_n_max: int = 64,
    coattn_n_max: Optional[int] = None,
    device=None,
) -> nn.Module:
    """The wire-compact pair predictor of the JAX package's
    ``make_packed_predictor(..., compact=True)`` for every packed encoder
    (``PORTED_METHODS`` and ``'ggnn-gwm'``), and with ``attn`` its
    co-attention predictor (:1327-1338) over any of them but GWM.
    ``layer_aggregator`` rides GGNN only, as in the JAX factory
    (:1262-1265).  ``s2s_n_max`` is the MPNN
    Set2Set table width: it must bound the largest molecule (the trainer
    fits it to its data); ``coattn_n_max``, the co-attention atom table
    width, sizes ``lt``'s weights."""
    bad = model_problems(method, sim_method, attn, layer_aggregator)
    if bad:
        raise ValueError("not ported: " + "; ".join(bad))
    encoder = _build_encoder(method, fp_out_dim, fp_hidden_dim, conv_layers,
                             weight_tying, layer_aggregator, s2s_n_max,
                             device)
    if method == "ggnn-gwm":
        from gcnbmp_tpu_torch.models import gwm

        head = make_head(sim_method, fp_out_dim, class_num,
                         tuple(net_hidden_dims), device=device)
        return gwm.PackedGWMPairPredictorCOOCompact(encoder, head)
    if attn is not None:
        coattention = build_coattention(attn, fp_hidden_dim, fp_out_dim,
                                        coattn_n_max, device=device)
        head = make_head(sim_method, coattention.out_width, class_num,
                         tuple(net_hidden_dims), device=device)
        return PackedCoattnPairPredictor(encoder, coattention, head)
    head = make_head(sim_method, fp_out_dim, class_num,
                     tuple(net_hidden_dims), device=device)
    return PackedPairPredictorCOOCompact(encoder, head)
