"""GGNN with the Graph Warp Module, over the padded and the packed
layouts (port of gcnbmp_tpu/models/gwm.py).

Ported pieces:

- ``supernode_features``, ``default_supernode_fn`` <- :389-425: the
  per-molecule supernode input, the sum/mean/max of the 66 DrugFP values per atom (198) zero-padded to
  ``DEFAULT_N_SUPER_FEATURE`` = 244, memoized per SMILES; fill rows and
  unparseable SMILES get the zero row
- ``GWMStep``         <- :45-85: one warp step over padded molecules; the
  node -> supernode attention over the N atom slots (scores masked to
  -1e9, softmax, then multiplied by the mask)
- ``GGNN_GWM``        <- :88-171: the padded encoder (dropout on the warp
  step's local output, ``concat_hidden`` with a readout per layer)
- ``GWMPairPredictor`` <- :356-386: the padded pair predictor, supernode
  rows required, ``symmetric`` the max/min of the head over both orders
- ``PackedGWMStep``   <- :174-227: one warp step; the node -> supernode
  multi-head attention is a softmax per molecule over its atom slots
  (``models.packed.segment_softmax``), the supernode -> node broadcast a
  gather by ``mol_id``
- ``PackedGGNN_GWM``  <- :230-297: GGNN messages, the ``pre_update``
  linear, the warp step and two shared GRUs per layer, then the gated
  readout summed per molecule, concatenated with the supernode state
  through ``linear_for_concat_super``
- ``PackedGWMPairPredictorCOOCompact`` <- :322-353, the wire-compact COO
  predictor; the port runs it for ``compute_path`` ``"packed"`` too (the
  JAX dense ``PackedGWMPairPredictor``, :300-319, computes the same
  logits from a host-built dense adjacency)

Parameter names follow the flax tree (``encoder/embed``,
``encoder/embed_super``, ``encoder/update_{i}/message/dense``,
``encoder/pre_update_{i}``, ``encoder/gwm_{i}/{super_query, local_key,
local_to_super, super_to_local, gate_local_self, gate_local_trans,
super_self, gate_super_self, gate_super_trans}``, ``encoder/gru_local``,
``encoder/gru_super``, ``encoder/readout_0/{i,j}``,
``encoder/linear_for_concat_super``, ``head/...``), so one checkpoint
serves the port and the JAX package's dense, compact and padded GWM
predictors.  With
weight tying one message, warp step and pre-update serve every layer;
the two GRUs are always shared.  No Pallas kernel computes GWM in the
JAX package (a fused GGNN layer cannot carry the pre-update and the warp
step between the message and the GRU): the port runs it as PyTorch ops
on the card, the same design.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from gcnbmp_tpu_torch.chem.featurize import drugfp_atom_features
from gcnbmp_tpu_torch.chem.mol import Mol
from gcnbmp_tpu_torch.models.ggnn import GGNNMessage
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM, ChainerGRUCell, EmbedAtomID, dropout)
from gcnbmp_tpu_torch.models.packed import (
    PackedCommonReadout, _segment_mol_sum, decode_compact_wire, pair_logits,
    segment_softmax)
from gcnbmp_tpu_torch.models.readouts import CommonGGNNReadout
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

DEFAULT_N_SUPER_FEATURE = 2 + 2 * 4 + MAX_ATOMIC_NUM * 2  # 244
N_HEADS = 8  # the JAX factory's (packed.py:1282-1286)


def supernode_features(mol: Mol,
                       n_super_feature: int = DEFAULT_N_SUPER_FEATURE
                       ) -> np.ndarray:
    """Sum, mean and max over the atoms of their DrugFP features,
    zero-padded (or cut) to ``n_super_feature`` f32 values."""
    feats = np.stack([drugfp_atom_features(mol, i)
                      for i in range(mol.num_atoms)])
    vec = np.concatenate([feats.sum(0), feats.mean(0), feats.max(0)])
    if len(vec) < n_super_feature:
        vec = np.pad(vec, (0, n_super_feature - len(vec)))
    return vec[:n_super_feature].astype(np.float32)


def default_supernode_fn(n_super_feature: int = DEFAULT_N_SUPER_FEATURE):
    """SMILES -> supernode feature vector (zeros for an empty or
    unparseable SMILES), memoized per SMILES: a DDI dataset has a few
    hundred drugs in ~100k pair rows.  The returned arrays are
    read-only, shared by every caller."""
    from gcnbmp_tpu_torch.chem.smiles import mol_from_smiles

    @functools.lru_cache(maxsize=65536)
    def cached(smiles: str) -> np.ndarray:
        mol = mol_from_smiles(smiles) if smiles else None
        if mol is None:
            arr = np.zeros((n_super_feature,), np.float32)
        else:
            arr = supernode_features(mol, n_super_feature)
        arr.setflags(write=False)
        return arr

    def fn(smiles: str) -> np.ndarray:
        return cached(smiles)

    return fn


class GWMStep(nn.Module):
    """One warp step over padded molecules: (h, h2, h_s) -> (merged_local,
    merged_super), with h (B, N, d) the node states before the GNN
    update, h2 after it and h_s (B, ds) the supernode states.

    The query of each molecule's supernode is laid out head-major,
    (B, k, d) from (B, k*d); scores are divided by sqrt(d), d the local
    width; over the N atom slots they are masked to -1e9, softmaxed and
    multiplied by the mask (``mask=None`` takes every slot)."""

    def __init__(self, hidden_dim: int, hidden_dim_super: int,
                 n_heads: int = N_HEADS, device=None):
        super().__init__()
        d, ds, k = hidden_dim, hidden_dim_super, n_heads
        self.hidden_dim, self.n_heads = d, k
        lin = lambda i, o: nn.Linear(i, o, device=device)
        self.super_query = lin(ds, k * d)
        self.local_key = lin(d, k * d)
        self.local_to_super = lin(k * d, ds)
        self.super_to_local = lin(ds, d)
        self.gate_local_self = lin(d, d)
        self.gate_local_trans = lin(d, d)
        self.super_self = lin(ds, ds)
        self.gate_super_self = lin(ds, ds)
        self.gate_super_trans = lin(ds, ds)

    def warp(self, h2, h_s, trans_local, heads):
        """The warp gates, from the local states h2, the supernode states
        h_s, the broadcast ``trans_local`` (shaped as h2) and the attention
        heads (per molecule, k*d wide)."""
        trans_super = torch.tanh(self.local_to_super(heads))
        z_local = torch.sigmoid(self.gate_local_self(h2)
                                + self.gate_local_trans(trans_local))
        merged_local = z_local * trans_local + (1.0 - z_local) * h2
        self_super = self.super_self(h_s)
        z_super = torch.sigmoid(self.gate_super_self(h_s)
                                + self.gate_super_trans(trans_super))
        merged_super = (z_super * trans_super
                        + (1.0 - z_super) * torch.tanh(self_super))
        return merged_local, merged_super

    def forward(self, h, h2, h_s, mask=None):
        d, k = self.hidden_dim, self.n_heads
        b, n, _ = h.shape
        q = torch.tanh(self.super_query(h_s)).reshape(b, 1, k, d)
        keys = torch.tanh(self.local_key(h)).reshape(b, n, k, d)
        scores = (keys * q).sum(-1) / math.sqrt(d)            # (B, N, k)
        if mask is not None:
            scores = torch.where(mask[..., None] > 0, scores,
                                 torch.full_like(scores, -1e9))
        attn = torch.softmax(scores, dim=1)
        if mask is not None:
            attn = attn * mask[..., None]
        heads = torch.einsum("bnk,bnd->bkd", attn, h).reshape(b, k * d)
        trans_local = torch.tanh(self.super_to_local(h_s))[:, None, :]
        return self.warp(h2, h_s, trans_local.expand_as(h2), heads)


class PackedGWMStep(GWMStep):
    """One warp step over packed tiles: (h, h2, h_s) -> (merged_local,
    merged_super), with h (P, T, d) the node states before the GNN
    update, h2 after it and h_s (M, ds) the supernode states.  The node
    -> supernode attention is a softmax per molecule over its slots
    (``segment_softmax``), the broadcast a gather by ``mol_id``.  Pad
    slots carry mol_id == M: their query row is zero, their attention
    weight 0, and they read the zero row of the broadcast."""

    def forward(self, h, h2, h_s, mol_id, node_mask, num_mols: int):
        d, k = self.hidden_dim, self.n_heads
        p, t, _ = h.shape
        ids = mol_id.reshape(-1).long()
        valid = node_mask.reshape(-1)
        # local -> super: multi-head attention per molecule
        q = torch.tanh(self.super_query(h_s))                 # (M, k*d)
        keys = torch.tanh(self.local_key(h))                  # (P, T, k*d)
        kh = keys.reshape(p * t, k, d)
        qh = torch.cat([q.reshape(num_mols, k, d),
                        q.new_zeros((1, k, d))])[ids]         # (N, k, d)
        scores = (kh * qh).sum(-1) / math.sqrt(d)              # (N, k)
        attn = segment_softmax(scores, ids, valid, num_mols + 1)
        h_flat = h.reshape(p * t, d)
        contrib = (attn[:, :, None] * h_flat[:, None, :]).reshape(p * t,
                                                                  k * d)
        heads = contrib.new_zeros((num_mols + 1, k * d)).index_add_(
            0, ids, contrib)[:num_mols]                        # (M, k*d)
        # super -> local: broadcast by gather
        tl = torch.tanh(self.super_to_local(h_s))             # (M, d)
        trans_local = torch.cat([tl, tl.new_zeros((1, d))])[mol_id.long()]
        return self.warp(h2, h_s, trans_local, heads)


class GGNN_GWM(nn.Module):
    """GGNN + Graph Warp Module over the padded layout: ``forward(atoms,
    adj, super_node (B, F_s), mask=None, deterministic=True,
    generator=None)`` -> (g, aux).  Dropout (``dropout_ratio``) is applied
    to the warp step's local output before the GRU."""

    def __init__(self, out_dim: int, hidden_dim: int = 16,
                 hidden_dim_super: int = 16, n_layers: int = 4,
                 n_heads: int = N_HEADS, n_atom_types: int = MAX_ATOMIC_NUM,
                 dropout_ratio: float = 0.0, concat_hidden: bool = False,
                 weight_tying: bool = True,
                 n_super_feature: int = DEFAULT_N_SUPER_FEATURE, device=None):
        super().__init__()
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.concat_hidden = concat_hidden
        self.dropout_ratio = dropout_ratio
        d, ds = hidden_dim, hidden_dim_super
        self.embed = EmbedAtomID(n_atom_types, d, device=device)
        self.embed_super = nn.Linear(n_super_feature, ds, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(d, device=device))
            self.add_module(f"gwm_{i}", GWMStep(d, ds, n_heads,
                                                device=device))
            self.add_module(f"pre_update_{i}", nn.Linear(2 * d, d,
                                                         device=device))
        self.gru_local = ChainerGRUCell(d, d, device=device)
        self.gru_super = ChainerGRUCell(ds, ds, device=device)
        for i in range(n_layers if concat_hidden else 1):
            self.add_module(f"readout_{i}", CommonGGNNReadout(
                2 * d, out_dim, device=device))
        if not concat_hidden:
            self.linear_for_concat_super = nn.Linear(out_dim + ds, out_dim,
                                                     device=device)
        self.out_width = out_dim * (n_layers if concat_hidden else 1)

    def layer(self, name: str, step: int) -> nn.Module:
        return getattr(self, f"{name}_{0 if self.weight_tying else step}")

    def forward(self, atoms, adj, super_node, mask=None,
                deterministic: bool = True, generator=None):
        h = self.embed(atoms) if not atoms.is_floating_point() else atoms
        h0 = h
        h_s = self.embed_super(super_node)
        state_local = torch.zeros_like(h)
        state_super = torch.zeros_like(h_s)
        g_list = []
        for step in range(self.n_layers):
            m = self.layer("update", step)(h, adj)
            h2 = self.layer("pre_update", step)(torch.cat([h, m], dim=-1))
            merged_local, merged_super = self.layer("gwm", step)(
                h, h2, h_s, mask)
            merged_local = dropout(merged_local, self.dropout_ratio,
                                   deterministic, generator)
            state_local = self.gru_local(state_local, merged_local)
            state_super = self.gru_super(state_super, merged_super)
            h, h_s = state_local, state_super
            if self.concat_hidden:
                g_list.append(getattr(self, f"readout_{step}")(h, h0, mask))
        aux = {"atoms": h, "h0": h0, "super": h_s, "h_list": [],
               "g_list": g_list}
        if self.concat_hidden:
            return torch.cat(g_list, dim=-1), aux
        g = self.readout_0(h, h0, mask)
        out = torch.relu(self.linear_for_concat_super(
            torch.cat([g, h_s], dim=-1)))
        return out, aux


class GWMPairPredictor(nn.Module):
    """Siamese GGNN_GWM pair predictor over padded batches:
    ``forward(atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
    super1=None, super2=None, deterministic=True, return_aux=False,
    generator=None)`` -> logits (and with ``return_aux`` the dict of
    ``g1``, ``g2``, ``aux1``, ``aux2``).  ``symmetric`` 'or'/'and' takes
    the max/min of the head over both orders of (g1, g2).
    ``supernode_fn`` is the function its batches' supernode rows are
    built with."""

    def __init__(self, encoder: GGNN_GWM, head: nn.Module,
                 symmetric: Optional[str] = None):
        super().__init__()
        self.encoder = encoder
        self.head = head
        self.symmetric = symmetric
        self.supernode_fn = default_supernode_fn()

    def forward(self, atoms1, adj1, atoms2, adj2, mask1=None, mask2=None,
                super1=None, super2=None, deterministic: bool = True,
                return_aux: bool = False, generator=None):
        if super1 is None or super2 is None:
            raise ValueError(
                "GWMPairPredictor requires supernode features (build "
                "batches with make_batch(..., supernode_fn=...))")
        g1, aux1 = self.encoder(atoms1, adj1, super1, mask1, deterministic,
                                generator)
        g2, aux2 = self.encoder(atoms2, adj2, super2, mask2, deterministic,
                                generator)
        logits = self.head(g1, g2)
        if self.symmetric == "or":
            logits = torch.maximum(logits, self.head(g2, g1))
        elif self.symmetric == "and":
            logits = torch.minimum(logits, self.head(g2, g1))
        if return_aux:
            return logits, {"g1": g1, "g2": g2, "aux1": aux1, "aux2": aux2}
        return logits


class PackedGGNN_GWM(nn.Module):
    """GGNN + Graph Warp Module encoder over packed tiles.  ``forward``
    takes the dense (P, 4, T, T) adjacency and the per-molecule supernode
    table ``supers`` (M, n_super_feature); returns (g (M, out_dim), aux).
    Deterministic only: ``dropout_ratio > 0`` is refused, as the JAX
    module refuses it."""

    def __init__(self, out_dim: int, hidden_dim: int = 16,
                 hidden_dim_super: int = 16, n_layers: int = 4,
                 n_heads: int = N_HEADS, n_atom_types: int = MAX_ATOMIC_NUM,
                 dropout_ratio: float = 0.0, weight_tying: bool = True,
                 n_super_feature: int = DEFAULT_N_SUPER_FEATURE, device=None):
        super().__init__()
        if dropout_ratio > 0:
            raise ValueError("packed GWM path supports dropout_ratio=0 only")
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        d, ds = hidden_dim, hidden_dim_super
        self.embed = EmbedAtomID(n_atom_types, d, device=device)
        self.embed_super = nn.Linear(n_super_feature, ds, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"update_{i}", GGNNMessage(d, device=device))
            self.add_module(f"gwm_{i}", PackedGWMStep(d, ds, n_heads,
                                                      device=device))
            self.add_module(f"pre_update_{i}", nn.Linear(2 * d, d,
                                                         device=device))
        self.gru_local = ChainerGRUCell(d, d, device=device)
        self.gru_super = ChainerGRUCell(ds, ds, device=device)
        self.readout_0 = PackedCommonReadout(2 * d, out_dim, device=device)
        self.linear_for_concat_super = nn.Linear(out_dim + ds, out_dim,
                                                 device=device)

    def layer(self, name: str, step: int) -> nn.Module:
        return getattr(self, f"{name}_{0 if self.weight_tying else step}")

    def forward(self, atom_ids, adj, supers, mol_id, node_mask,
                num_mols: int):
        h = self.embed(atom_ids)
        h0 = h
        h_s = self.embed_super(supers)
        state_local = torch.zeros_like(h)
        state_super = torch.zeros_like(h_s)
        for step in range(self.n_layers):
            m = self.layer("update", step)(h, adj)
            h2 = self.layer("pre_update", step)(torch.cat([h, m], dim=-1))
            merged_local, merged_super = self.layer("gwm", step)(
                h, h2, h_s, mol_id, node_mask, num_mols)
            state_local = self.gru_local(state_local, merged_local)
            state_super = self.gru_super(state_super, merged_super)
            h, h_s = state_local, state_super
        g = _segment_mol_sum(self.readout_0(h, h0, node_mask), mol_id,
                             num_mols)
        out = torch.relu(self.linear_for_concat_super(
            torch.cat([g, h_s], dim=-1)))
        return out, {"atoms": h, "h0": h0, "super": h_s}

    def encode(self, atom_ids, edges, mol_id, node_mask, num_mols: int,
               supers):
        """Per-molecule embeddings (num_mols, D) from the decoded COO
        edges (e_tile, e_type, e_src, e_dst, e_mask), on the dense
        adjacency built from them."""
        p, t = atom_ids.shape
        adj = adj_from_coo(*edges, num_tiles=p, tile=t)
        return self(atom_ids, adj, supers, mol_id, node_mask, num_mols)[0]


class PackedGWMPairPredictorCOOCompact(nn.Module):
    """GWM pair predictor over the wire-compact COO batch: (nodes (2, P,
    T), e_packed (E,), n_edges (), supers (M, F), left_index (B,),
    right_index (B,)) -> logits (B, C).  ``supernode_fn`` is the
    function its batches' supernode tables are built with."""

    def __init__(self, encoder: PackedGGNN_GWM, head: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.head = head
        self.supernode_fn = default_supernode_fn()

    def wire_encoder(self, datasets=(), n_max: Optional[int] = None):
        from gcnbmp_tpu_torch.data.wire import compact_gwm_arrays

        return compact_gwm_arrays

    def forward(self, nodes, e_packed, n_edges, supers, left_index,
                right_index, return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        atom_ids, mol_id, node_mask, *edges = decode_compact_wire(
            nodes, e_packed, n_edges, num_mols)
        g = self.encoder.encode(atom_ids, edges, mol_id, node_mask,
                                num_mols, supers)
        return pair_logits(self.head, g, left_index, right_index, return_g)
