"""Packed-supergraph pair predictors (port of gcnbmp_tpu/models/packed.py).

Ported pieces:

- ``PackedGatedReadout``            <- :29-41
- ``_segment_mol_sum``              <- :67-87
- ``PackedGGNN``                    <- :147-210 (the plain layer stack); its
  kernel path ``fused_forward`` is ``_fused_encoder_g_nodes`` (:1102-1133)
  of ``fused_compact_logits`` (:1176-1212) in either form that
  ``FUSED_READOUT`` picks -> segment sum
- ``PackedSet2Set``                 <- :343-430, the dense mode
- ``_device_slot_table``            <- :433-455
- ``PackedMPNNReadout``             <- :458-478
- ``PackedEdgeNet``                 <- :531-613, the default ``dotgen`` form
- ``PackedMPNN``                    <- :669-815, EdgeNet messages and the
  Set2Set readout; its kernel path ``fused_forward`` is the JAX module's
  fused branch (:717-774): K5 -> slot table -> K4 -> linear1, relu, linear2
- ``decode_compact_wire``           <- :918-936
- ``PackedPairPredictorCOOCompact`` <- :939-971: embed -> flat adjacency ->
  the encoder's kernel path -> left and right gather -> HolE
- ``make_packed_predictor``         <- :1235-1347, the ``method="ggnn"``
  and ``method="mpnn"`` branches, no co-attention, no layer aggregator;
  ``model_kwargs_from_config`` reads its arguments from a run config.

Parameter names match the flax trees (``encoder/embed``,
``encoder/update_{i}/message/dense``, ``encoder/gru/...``,
``encoder/readout_0/{i,j}`` for GGNN; ``encoder/message_{i}/nn1|nn2``,
``encoder/gru_{i}/...``, ``encoder/readout_0/set2set/lstm/...``,
``encoder/readout_0/linear1|linear2`` for MPNN; ``head/mlp/...``).  On
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

from gcnbmp_tpu_torch.models.ggnn import NUM_EDGE_TYPE, GGNNMessage
from gcnbmp_tpu_torch.models.heads import make_head
from gcnbmp_tpu_torch.models.layers import (
    MAX_ATOMIC_NUM,
    ChainerGRUCell,
    EmbedAtomID,
    GraphLinear,
    OptimizedLSTMCell,
)
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat
from gcnbmp_tpu_torch.ops.fused_ggnn import (
    fused_ggnn, fused_ggnn_readout, params_to_fused)
from gcnbmp_tpu_torch.ops.fused_mpnn import fused_mpnn, params_to_fused_mpnn
from gcnbmp_tpu_torch.ops.set2set_kernel import NEG, fused_set2set
from gcnbmp_tpu_torch.ops.slotgather import gather_slot_table, identity_mol_row


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
               out_dim: Optional[int] = None) -> str:
    """The kernels the GGNN kernel path runs under the current flags for
    a model of these widths (unnamed widths: D = H)."""
    from gcnbmp_tpu_torch.ops import fused_ggnn as fg

    if readout_in_kernel(hidden_dim, out_dim):
        return "K2/K2b (gated readout in the kernel)"
    if fg.TWOPASS:
        return "K1m/K3 (two-pass backward) + plain readout"
    return "K1/K1b + plain readout"


class PackedGGNN(nn.Module):
    """GGNN encoder over packed tiles.  ``forward`` is the plain layer
    stack of the JAX module (dense (P, 4, T, T) adjacency);
    ``fused_forward``, the predictor's path, reads these weights through
    ``params_to_fused`` into the kernels, in the form ``FUSED_READOUT``
    picks.

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

    def fused_forward(self, atom_ids, adj_flat, mol_id, node_mask,
                      num_mols: int) -> torch.Tensor:
        """Per-molecule embeddings (num_mols, D) from the flat (P, T, 4T)
        adjacency: through K2 (K2b in the backward), or K1 and the plain
        readout (K1b, or K3 twice, in the backward), by ``FUSED_READOUT``
        and the widths (``readout_in_kernel``)."""
        h0 = self.embed(atom_ids)
        msg_w, msg_b, gru = params_to_fused(self)
        ro = self.readout_0
        if readout_in_kernel(self.hidden_dim, self.out_dim):
            g_nodes = fused_ggnn_readout(
                self.n_layers, h0, adj_flat, msg_w, msg_b, gru, node_mask,
                ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
        else:
            h = fused_ggnn(self.n_layers, h0, adj_flat, msg_w, msg_b, gru)
            g_nodes = ro(h, h0, node_mask)
        return _segment_mol_sum(g_nodes, mol_id, num_mols)


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
    """MPNN encoder over packed tiles: EdgeNet messages, a GRU per layer
    and the Set2Set readout.  Weight tying shares ONE message function and
    ONE GRU, whose state carries across the layers; untied layers each
    have their own and restart from a zero state, as in the JAX module.
    ``forward`` is the plain layer stack (dense adjacency);
    ``fused_forward``, the predictor's path, runs K5 and K4."""

    def __init__(self, out_dim: int, hidden_dim: int = 16, n_layers: int = 4,
                 n_atom_types: int = MAX_ATOMIC_NUM, weight_tying: bool = True,
                 edge_hidden_dim: int = 16, s2s_n_max: int = 64, device=None):
        super().__init__()
        self.out_dim = out_dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.weight_tying = weight_tying
        self.embed = EmbedAtomID(n_atom_types, hidden_dim, device=device)
        for i in range(1 if weight_tying else n_layers):
            self.add_module(f"message_{i}", PackedEdgeNet(
                hidden_dim, edge_hidden_dim, device=device))
            self.add_module(f"gru_{i}", ChainerGRUCell(
                2 * hidden_dim, hidden_dim, device=device))
        self.readout_0 = PackedMPNNReadout(out_dim, hidden_dim,
                                           s2s_n_max=s2s_n_max, device=device)

    def message(self, layer: int) -> PackedEdgeNet:
        return getattr(self, f"message_{0 if self.weight_tying else layer}")

    def gru(self, layer: int) -> ChainerGRUCell:
        return getattr(self, f"gru_{0 if self.weight_tying else layer}")

    def forward(self, atom_ids, adj, mol_id, node_mask, num_mols: int):
        h = self.embed(atom_ids)
        h0 = h
        states = {}
        for step in range(self.n_layers):
            k = 0 if self.weight_tying else step
            x = self.message(step)(h, adj, mol_id, node_mask, num_mols)
            h = self.gru(step)(states.get(k, torch.zeros_like(h)), x)
            states[k] = h
        g = self.readout_0(h, mol_id, node_mask, num_mols)
        return g, {"atoms": h, "h0": h0}

    def fused_forward(self, atom_ids, adj_flat, mol_id, node_mask,
                      num_mols: int) -> torch.Tensor:
        """Per-molecule embeddings (num_mols, D) through K5 and K4 (K5b
        and K4b in the backward), from the flat (P, T, 4T) adjacency."""
        h0 = self.embed(atom_ids)
        wt, m0t, gru = params_to_fused_mpnn(self)
        h = fused_mpnn(self.n_layers, self.weight_tying, h0, adj_flat,
                       mol_id.to(torch.int32).contiguous(), node_mask, wt,
                       m0t, gru)
        return self.readout_0(h, mol_id, node_mask, num_mols, fused=True)


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

    def __init__(self, encoder: nn.Module, head: nn.Module):
        super().__init__()
        self.encoder = encoder  # a PackedGGNN or a PackedMPNN
        self.head = head

    def forward(self, nodes, e_packed, n_edges, left_index, right_index,
                return_g: bool = False):
        num_mols = 2 * left_index.shape[0]
        (atom_ids, mol_id, node_mask, e_tile, e_type, e_src, e_dst,
         e_mask) = decode_compact_wire(nodes, e_packed, n_edges, num_mols)
        p, t = atom_ids.shape
        adj_flat = adj_from_coo_flat(e_tile, e_type, e_src, e_dst, e_mask,
                                     num_tiles=p, tile=t)
        g = self.encoder.fused_forward(atom_ids, adj_flat, mol_id, node_mask,
                                       num_mols)
        g1 = g[left_index.long()]
        g2 = g[right_index.long()]
        logits = self.head(g1, g2)
        if return_g:
            return logits, g1, g2
        return logits


# Model fields of a run config and the values the port builds.
# compute_path is not read: the packed and padded parameter trees are the
# same, and the port always runs the packed kernel path of the encoder.
# compute_dtype is a training knob (the trainer takes bfloat16 for mpnn
# and computes in f32); serving runs in f32, as the JAX packed evaluator
# does.
PORTED_METHODS = ("ggnn", "mpnn")
_REQUIRED = {
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
    **_REQUIRED, "method": "ggnn", "fp_hidden_dim": 16, "fp_out_dim": 16,
    "conv_layers": 4, "weight_tying": True, "net_hidden_dims": (),
    "class_num": 1,
}


def model_kwargs_from_config(cfg: dict) -> dict:
    """``make_packed_predictor`` kwargs from a run config dict (a
    ``config.json``, the port's or a JAX run's); raises ValueError on any
    model value outside what the port builds.  The Set2Set table width
    is not a config field: it takes ``make_packed_predictor``'s default,
    as the JAX evaluator does, unless the caller adds it."""
    get = lambda k: cfg.get(k, _DEFAULTS[k])
    bad = [f"{k}={get(k)!r} (ported: {v!r})" for k, v in _REQUIRED.items()
           if get(k) != v]
    if get("method") not in PORTED_METHODS:
        bad.insert(0, f"method={get('method')!r} (ported: "
                      f"{', '.join(map(repr, PORTED_METHODS))})")
    if bad:
        raise ValueError("config outside the ported model: "
                         + ", ".join(bad))
    return {
        "method": get("method"),
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
    s2s_n_max: int = 64,
    device=None,
) -> PackedPairPredictorCOOCompact:
    """The wire-compact pair predictor of the JAX package's
    ``make_packed_predictor(..., compact=True)`` for the GGNN and MPNN
    families.  ``s2s_n_max`` is the MPNN Set2Set table width: it must
    bound the largest molecule (the trainer fits it to its data)."""
    if method not in PORTED_METHODS:
        raise ValueError(
            f"method {method!r} is not ported yet: the other packed encoders "
            "come later (ROADMAP queue 1, item 9)")
    if attn is not None:
        raise ValueError("co-attention is not ported yet "
                         "(ROADMAP queue 1, item 8)")
    if layer_aggregator is not None:
        raise ValueError("layer_aggregator is not ported yet "
                         "(ROADMAP queue 1, item 9)")
    if method == "mpnn":
        encoder = PackedMPNN(out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
                             n_layers=conv_layers, weight_tying=weight_tying,
                             s2s_n_max=s2s_n_max, device=device)
    else:
        encoder = PackedGGNN(out_dim=fp_out_dim, hidden_dim=fp_hidden_dim,
                             n_layers=conv_layers, weight_tying=weight_tying,
                             device=device)
    head = make_head(sim_method, fp_out_dim, class_num,
                     tuple(net_hidden_dims), device=device)
    return PackedPairPredictorCOOCompact(encoder, head)
