"""Fused multi-layer MPNN (EdgeNet message + GRU) over packed 128-atom
tiles, forward and backward.

Port of gcnbmp_tpu/ops/fused_mpnn.py:

- ``build_molmat``        <- ``build_molmat`` (:362)
- ``fused_mpnn``    (K5)  <- ``fused_mpnn`` / ``_fwd_kernel``, ``_mpnn_layer_fwd``
- ``fused_mpnn_bwd`` (K5b) <- ``_fused_mpnn_bwd`` / ``_bwd_kernel``

Per layer l, with this layer's weights (wt (4, C, C) = (M_e - M0)^T,
m0t (C, C) = M0^T and a GRU of its own):

    hm_e = h wt_e                               e = 0..3 (edge types)
    out_i = sum_{e,j} A[i, eT+j] hm_e[j]        (the flat (T, 4T) adjacency)
    in_j  = sum_{e,i} A[i, eT+j] hm_e[i]        (its transposed blocks)
    bg    = (Mmol h) m0t                        Mmol[i, j] = 1 iff i and j are
                                                real slots of one molecule
    x     = [out + bg, in + bg]
    h'    = ChainerGRU(state, x)                state = 0 at layer 0; later
                                                layers carry h when
                                                ``carry_state`` (tied
                                                weights), else restart at 0

The molecule matrix is not an input: the functions take the tile's
``mol_id`` and ``node_mask`` and the plain versions build Mmol with
``build_molmat``; the kernels form the per-molecule sums from the ids
directly.  ``fused_mpnn`` is differentiable in h0 and every weight through
``FusedMPNNFunction`` (the port of ``fused_mpnn.defvjp``), whose backward
recomputes the layers from the saved inputs, as the TPU kernel does.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU; for a CUDA tensor it launches the hand-written Hopper
kernel (``csrc/fused_mpnn.cu``) or raises.  Launches are counted in
``fused_mpnn.launches`` and ``fused_mpnn_bwd.launches``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.autograd.function import once_differentiable

from gcnbmp_tpu_torch.ops.fused_ggnn import (
    GRU_KEYS,
    NUM_EDGE_TYPE,
    TILE,
    _check,
    _raise_on,
    _rows,
    _stream,
)

# widths the kernels' shared-memory plans are instantiated for
KERNEL_HIDDEN = (16, 32)


def gru_stack_shape(key: str, n_layers: int, hidden: int) -> Tuple[int, ...]:
    """Shape of one per-layer GRU stack (wz/wr/wn, uz/ur/un, bz/br/bn)."""
    return ((n_layers, hidden) if key.startswith("b") else
            (n_layers, 2 * hidden, hidden) if key.startswith("w") else
            (n_layers, hidden, hidden))


def build_molmat(mol_id: torch.Tensor, node_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(P, T, T) molecule-equality matrix: 1 where two real slots of a
    tile share a molecule id (molecules never span tiles)."""
    eq = mol_id[:, :, None] == mol_id[:, None, :]
    real = (node_mask[:, :, None] > 0) & (node_mask[:, None, :] > 0)
    return (eq & real).to(dtype)


# ---------------------------------------------------------------------------
# plain versions


def _layer_parts(h, state, adj, molmat, wt, m0t, gru):
    """One layer with layer-sliced weights: (h', (x, z, r, n)), as
    ``_mpnn_layer_fwd`` and ``_gru_fwd``."""
    p, t, ch = h.shape
    hm = torch.cat([h @ wt[e] for e in range(NUM_EDGE_TYPE)], dim=1)  # (P, 4T, C)
    out = torch.bmm(adj, hm)
    inn = torch.einsum("piej,peic->pjc", adj.reshape(p, t, NUM_EDGE_TYPE, t),
                       hm.reshape(p, NUM_EDGE_TYPE, t, ch))
    bg = torch.bmm(molmat, h) @ m0t
    x = torch.cat([out + bg, inn + bg], dim=-1)
    z = torch.sigmoid(x @ gru["wz"] + state @ gru["uz"] + gru["bz"])
    r = torch.sigmoid(x @ gru["wr"] + state @ gru["ur"] + gru["br"])
    n = torch.tanh(x @ gru["wn"] + (r * state) @ gru["un"] + gru["bn"])
    return z * n + (1.0 - z) * state, (x, z, r, n)


def _layer_gru(gru, l):
    return {k: gru[k][l] for k in GRU_KEYS}


def _forward_layers(n_layers, carry_state, h0, adj, molmat, wt, m0t, gru):
    """Final h and the input of every layer."""
    h = h0
    state = torch.zeros_like(h0)
    inputs = []
    for l in range(n_layers):
        inputs.append(h)
        h, _ = _layer_parts(h, state, adj, molmat, wt[l], m0t[l],
                            _layer_gru(gru, l))
        state = h if carry_state else state
    return h, inputs


def fused_mpnn_reference(n_layers: int, carry_state: bool, h0, adj_flat,
                         mol_id, node_mask, wt, m0t, gru):
    """Plain PyTorch K5 (the math of ``_fwd_kernel``)."""
    molmat = build_molmat(mol_id, node_mask, h0.dtype)
    return _forward_layers(n_layers, carry_state, h0, adj_flat, molmat, wt,
                           m0t, gru)[0]


def fused_mpnn_bwd_reference(n_layers: int, carry_state: bool, h0, adj_flat,
                             mol_id, node_mask, wt, m0t, gru, dh_final):
    """Plain PyTorch K5b in closed form (``_bwd_kernel``): (dh0, dwt,
    dm0t, dgru) for the upstream gradient dh_final of ``fused_mpnn``."""
    molmat = build_molmat(mol_id, node_mask, h0.dtype)
    _, inputs = _forward_layers(n_layers, carry_state, h0, adj_flat, molmat,
                                wt, m0t, gru)
    p, t, ch = h0.shape
    adj = adj_flat
    adj_t = adj.transpose(1, 2)                           # (P, 4T, T)
    dwt = torch.zeros_like(wt)
    dm0t = torch.zeros_like(m0t)
    dgru = {k: torch.zeros_like(gru[k]) for k in GRU_KEYS}
    dh = dh_final
    for l in range(n_layers - 1, -1, -1):
        h_in = inputs[l]
        carry = carry_state and l > 0
        state = h_in if carry else torch.zeros_like(h_in)
        g = _layer_gru(gru, l)
        _, (x, z, r, n) = _layer_parts(h_in, state, adj, molmat, wt[l],
                                       m0t[l], g)
        dz = dh * (n - state)
        dn = dh * z
        dstate = dh * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dz_pre = dz * z * (1.0 - z)
        drs = dn_pre @ g["un"].T
        dr_pre = drs * state * r * (1.0 - r)
        dstate = dstate + drs * r
        dx = dz_pre @ g["wz"].T + dr_pre @ g["wr"].T + dn_pre @ g["wn"].T
        dstate = dstate + dz_pre @ g["uz"].T + dr_pre @ g["ur"].T
        for key, left, right in (("wz", x, dz_pre), ("wr", x, dr_pre),
                                 ("wn", x, dn_pre), ("uz", state, dz_pre),
                                 ("ur", state, dr_pre),
                                 ("un", r * state, dn_pre)):
            dgru[key][l] = _rows(left).T @ _rows(right)
        for key, d in (("bz", dz_pre), ("br", dr_pre), ("bn", dn_pre)):
            dgru[key][l] = _rows(d).sum(0)
        dout, din = dx[..., :ch], dx[..., ch:]
        # background: bg = (Mmol h) m0t, fed to both halves of x
        dbg = dout + din
        dm0t[l] = _rows(torch.bmm(molmat, h_in)).T @ _rows(dbg)
        dh_in = torch.bmm(molmat.transpose(1, 2), dbg @ m0t[l].T)
        # out = A_flat hm -> dhm += A_flat^T dout; in_e = A_e^T hm_e -> dhm_e += A_e din
        dhw = torch.bmm(adj_t, dout)                      # (P, 4T, C)
        for e in range(NUM_EDGE_TYPE):
            cols = slice(e * TILE, (e + 1) * TILE)
            dhm_e = dhw[:, cols] + torch.bmm(adj[:, :, cols], din)
            dwt[l, e] = _rows(h_in).T @ _rows(dhm_e)
            dh_in = dh_in + dhm_e @ wt[l, e].T
        dh = dh_in + dstate if carry else dh_in
    return dh, dwt, dm0t, dgru


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_inputs(n_layers, h0, adj, mol_id, node_mask, wt, m0t, gru):
    if h0.device.type != "cuda":
        raise RuntimeError(f"fused MPNN kernels run on CUDA or CPU tensors, "
                           f"got {h0.device}")
    p, t, hidden = h0.shape
    if t != TILE:
        raise ValueError(f"tiles must hold {TILE} atoms, got {t}")
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"hidden width {hidden} is not one the kernel's "
                         f"shared-memory plan holds {KERNEL_HIDDEN}")
    if n_layers < 1 or wt.shape[0] != n_layers:
        raise ValueError(f"n_layers={n_layers} but wt has {wt.shape[0]} "
                         "layers")
    dev = h0.device
    _check("h0", h0, (p, TILE, hidden), dev)
    _check("adj_flat", adj, (p, TILE, NUM_EDGE_TYPE * TILE), dev)
    _check("node_mask", node_mask, (p, TILE), dev)
    if mol_id.device != dev or mol_id.dtype != torch.int32 or \
            tuple(mol_id.shape) != (p, TILE) or not mol_id.is_contiguous():
        raise ValueError(f"mol_id must be a contiguous int32 ({p}, {TILE}) "
                         f"tensor on {dev}")
    _check("wt", wt, (n_layers, NUM_EDGE_TYPE, hidden, hidden), dev)
    _check("m0t", m0t, (n_layers, hidden, hidden), dev)
    for k in GRU_KEYS:
        _check(f"gru[{k!r}]", gru[k], gru_stack_shape(k, n_layers, hidden),
               dev)
    return p, hidden


def _weight_ptrs(wt, m0t, gru) -> List[int]:
    return [wt.data_ptr(), m0t.data_ptr()] + [gru[k].data_ptr()
                                              for k in GRU_KEYS]


def _fused_mpnn_fwd(n_layers, carry_state, h0, adj, mol_id, node_mask, wt,
                    m0t, gru):
    """K5 on the tensors' device (plain version on the CPU)."""
    if h0.device.type == "cpu":
        return fused_mpnn_reference(n_layers, carry_state, h0, adj, mol_id,
                                    node_mask, wt, m0t, gru)
    from gcnbmp_tpu_torch.ops.build import load_library

    p, hidden = _check_inputs(n_layers, h0, adj, mol_id, node_mask, wt, m0t,
                              gru)
    lib = load_library()
    out = torch.empty_like(h0)
    with torch.cuda.device(h0.device):  # launch in the tensors' context
        err = lib.fused_mpnn_fwd(
            h0.data_ptr(), adj.data_ptr(), mol_id.data_ptr(),
            node_mask.data_ptr(), *_weight_ptrs(wt, m0t, gru),
            out.data_ptr(), p, n_layers, hidden, int(carry_state), _stream())
    _raise_on(err, "fused_mpnn_fwd")
    fused_mpnn.launches += 1
    return out


def _grad_shapes(n_layers: int, hidden: int) -> List[Tuple[int, ...]]:
    """The order of K5b's summed gradient row (``MpnnGradLayout`` in
    csrc/fused_mpnn.cu): dwt, dm0t, then the GRU stacks in GRU_KEYS
    order."""
    return ([(n_layers, NUM_EDGE_TYPE, hidden, hidden),
             (n_layers, hidden, hidden)]
            + [gru_stack_shape(k, n_layers, hidden) for k in GRU_KEYS])


def fused_mpnn_bwd(n_layers: int, carry_state: bool, h0, adj_flat, mol_id,
                   node_mask, wt, m0t, gru, dh_final):
    """K5b: (dh0, dwt, dm0t, dgru) for the upstream gradient dh_final
    (P, T, C) of ``fused_mpnn``'s output."""
    if h0.device.type == "cpu":
        return fused_mpnn_bwd_reference(n_layers, carry_state, h0, adj_flat,
                                        mol_id, node_mask, wt, m0t, gru,
                                        dh_final)
    from gcnbmp_tpu_torch.ops.build import load_library

    p, hidden = _check_inputs(n_layers, h0, adj_flat, mol_id, node_mask, wt,
                              m0t, gru)
    dev = h0.device
    _check("dh_final", dh_final, (p, TILE, hidden), dev)
    lib = load_library()
    shapes = _grad_shapes(n_layers, hidden)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    n_grad = sum(sizes)
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty((p, TILE, hidden), **f32)
    partial = torch.empty((p, n_grad), **f32)
    grads = torch.empty((n_grad,), **f32)
    hs = torch.empty((p, n_layers, TILE, hidden), **f32)
    with torch.cuda.device(dev):
        err = lib.fused_mpnn_bwd(
            h0.data_ptr(), adj_flat.data_ptr(), mol_id.data_ptr(),
            node_mask.data_ptr(), *_weight_ptrs(wt, m0t, gru),
            dh_final.data_ptr(), dh0.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), hs.data_ptr(), p, n_layers, hidden,
            int(carry_state), _stream())
    _raise_on(err, "fused_mpnn_bwd")
    fused_mpnn_bwd.launches += 1
    parts = [g.view(s) for g, s in zip(grads.split(sizes), shapes)]
    return dh0, parts[0], parts[1], dict(zip(GRU_KEYS, parts[2:]))


fused_mpnn_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd


class FusedMPNNFunction(torch.autograd.Function):
    """K5 forward, K5b backward: the port of ``fused_mpnn.defvjp``
    (fused_mpnn.py:359).  Saves the inputs, not activations; adj_flat,
    mol_id and node_mask get no gradient."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, n_layers, carry_state, h0, adj_flat, mol_id, node_mask,
                wt, m0t, *gru_values):
        ctx.n_layers, ctx.carry_state = n_layers, carry_state
        ctx.save_for_backward(h0, adj_flat, mol_id, node_mask, wt, m0t,
                              *gru_values)
        return _fused_mpnn_fwd(n_layers, carry_state, h0, adj_flat, mol_id,
                               node_mask, wt, m0t,
                               dict(zip(GRU_KEYS, gru_values)))

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        FusedMPNNFunction.backward_calls += 1
        h0, adj_flat, mol_id, node_mask, wt, m0t, *gru_values = \
            ctx.saved_tensors
        dh0, dwt, dm0t, dgru = fused_mpnn_bwd(
            ctx.n_layers, ctx.carry_state, h0, adj_flat, mol_id, node_mask,
            wt, m0t, dict(zip(GRU_KEYS, gru_values)), dh.contiguous())
        return (None, None, dh0, None, None, None, dwt, dm0t,
                *(dgru[k] for k in GRU_KEYS))


def fused_mpnn(n_layers: int, carry_state: bool, h0, adj_flat, mol_id,
               node_mask, wt, m0t, gru: Dict[str, torch.Tensor]):
    """K5: run n_layers EdgeNet-MPNN layers over packed tiles;
    differentiable in h0 and the weights (K5b).

    h0 (P, T, C); adj_flat (P, T, 4T) (``adj_from_coo_flat``); mol_id
    (P, T) int32 and node_mask (P, T) f32 of the packed batch; wt
    (L, 4, C, C); m0t (L, C, C); gru: per-layer stacks wz/wr/wn
    (L, 2C, C), uz/ur/un (L, C, C), bz/br/bn (L, C).  Returns (P, T, C)."""
    return FusedMPNNFunction.apply(n_layers, carry_state, h0, adj_flat,
                                   mol_id, node_mask, wt, m0t,
                                   *(gru[k] for k in GRU_KEYS))


fused_mpnn.launches = 0


# ---------------------------------------------------------------------------
# weight conversion


def params_to_fused_mpnn(encoder) -> Tuple[torch.Tensor, torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """The kernel's weight format from a ``models.packed.PackedMPNN`` (the
    re-layout of packed.py:727-763): per layer, M0 and M_e from the
    EdgeNet's nn1/nn2, wt = (M_e - M0)^T (4, C, C), m0t = M0^T, and the
    GRU's kernels (in, out) with the two biases of each gate summed.  A
    tied encoder stacks its one set L times; autograd sums the L
    gradients back."""
    per = []
    for k in range(1 if encoder.weight_tying else encoder.n_layers):
        m0, m_types = encoder.message(k).matrices()
        g = encoder.gru(k)
        per.append(((m_types - m0).transpose(1, 2), m0.T, {
            "wz": g.W_z.weight.T, "uz": g.U_z.weight.T,
            "bz": g.W_z.bias + g.U_z.bias,
            "wr": g.W_r.weight.T, "ur": g.U_r.weight.T,
            "br": g.W_r.bias + g.U_r.bias,
            "wn": g.W.weight.T, "un": g.U.weight.T, "bn": g.W.bias + g.U.bias,
        }))
    layers = [per[0 if encoder.weight_tying else l]
              for l in range(encoder.n_layers)]
    wt = torch.stack([w for w, _, _ in layers]).contiguous()
    m0t = torch.stack([m for _, m, _ in layers]).contiguous()
    gru = {k: torch.stack([g[k] for _, _, g in layers]).contiguous()
           for k in GRU_KEYS}
    return wt, m0t, gru
