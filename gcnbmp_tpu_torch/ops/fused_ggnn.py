"""Fused multi-layer GGNN forward over packed 128-atom tiles.

Port of the forward kernels of gcnbmp_tpu/ops/fused_ggnn.py:

- ``fused_ggnn``          (K1) <- ``fused_ggnn`` / ``_fwd_kernel``
- ``fused_ggnn_readout``  (K2) <- ``fused_ggnn_readout`` / ``_fwd_readout_kernel``

Per layer (semantics of the packed GGNN stack):

    hw_e = h @ W_e + b_e                      (per edge type e = 0..3)
    m    = A_flat (T, 4T) @ [hw_0; ...; hw_3] (4T, H)
    z    = sigmoid(x Wz + s Uz + bz),  x = [h, m]
    r    = sigmoid(x Wr + s Ur + br)
    n    = tanh(x Wn + (r*s) Un + bn)
    h'   = z*n + (1-z)*s                      s = 0 at layer 0, else h

K2 ends with the gated readout ``sigmoid([h, h0] Wi + bi) * (h Wj + bj) *
mask``.  Each wrapper takes its plain PyTorch version (``*_reference``)
for a tensor on the CPU; for a CUDA tensor it launches the hand-written
Hopper kernel (``csrc/fused_ggnn.cu``) or raises.  Each wrapper counts
its kernel launches in its ``launches`` attribute.

The kernels run the forward only (serving); the backward kernels come
with the training step.  The JAX package's TPU A/B knobs are not ported:
AGG_KBATCH, MERGE_GATES, MATMUL_BF16, TWOPASS and GCNBMP_FUSED_BWD_K
select among equivalent forms or precisions of the same math on the TPU.
Adjacency is taken in f32, the serving default.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

TILE = 128
NUM_EDGE_TYPE = 4
# widths the kernels' shared-memory plan is instantiated for; the
# readout width D equals H
KERNEL_HIDDEN = (16, 32)
GRU_KEYS = ("wz", "uz", "bz", "wr", "ur", "br", "wn", "un", "bn")


# ---------------------------------------------------------------------------
# plain versions


def _layer_reference(h, state, adj, wmsg, bmsg, gru):
    p, t, hidden = h.shape
    hw = torch.cat([h @ wmsg[e] + bmsg[e] for e in range(NUM_EDGE_TYPE)],
                   dim=1)                                  # (P, 4T, H)
    m = torch.bmm(adj, hw)                                 # (P, T, H)
    x = torch.cat([h, m], dim=-1)
    z = torch.sigmoid(x @ gru["wz"] + state @ gru["uz"] + gru["bz"])
    r = torch.sigmoid(x @ gru["wr"] + state @ gru["ur"] + gru["br"])
    n = torch.tanh(x @ gru["wn"] + (r * state) @ gru["un"] + gru["bn"])
    return z * n + (1.0 - z) * state


def fused_ggnn_reference(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """Plain PyTorch K1 (same math as the JAX ``_layer_fwd``)."""
    h = h0
    state = torch.zeros_like(h0)
    for l in range(n_layers):
        h = _layer_reference(h, state, adj, msg_w[l], msg_b[l], gru)
        state = h
    return h


def readout_reference(h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    gate = torch.sigmoid(torch.cat([h, h0], dim=-1) @ ro_wi + ro_bi)
    return gate * (h @ ro_wj + ro_bj) * node_mask[..., None]


def fused_ggnn_readout_reference(n_layers: int, h0, adj, msg_w, msg_b, gru,
                                 node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    """Plain PyTorch K2 (same math as the JAX ``_readout_fwd``)."""
    h = fused_ggnn_reference(n_layers, h0, adj, msg_w, msg_b, gru)
    return readout_reference(h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj)


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(name: str, x: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(n_layers, h0, adj, msg_w, msg_b, gru):
    if h0.device.type != "cuda":
        raise RuntimeError(f"fused GGNN kernels run on CUDA or CPU tensors, "
                           f"got {h0.device}")
    p, t, hidden = h0.shape
    if t != TILE:
        raise ValueError(f"tiles must hold {TILE} atoms, got {t}")
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"hidden width {hidden} is not one the kernel's "
                         f"shared-memory plan holds {KERNEL_HIDDEN}")
    if n_layers < 1 or msg_w.shape[0] != n_layers:
        raise ValueError(f"n_layers={n_layers} but msg_w has "
                         f"{msg_w.shape[0]} layers")
    dev = h0.device
    _check("h0", h0, (p, TILE, hidden), dev)
    _check("adj", adj, (p, TILE, NUM_EDGE_TYPE * TILE), dev)
    _check("msg_w", msg_w, (n_layers, NUM_EDGE_TYPE, hidden, hidden), dev)
    _check("msg_b", msg_b, (n_layers, NUM_EDGE_TYPE, hidden), dev)
    for k in GRU_KEYS:
        shape = ((hidden,) if k.startswith("b") else
                 (2 * hidden, hidden) if k.startswith("w") else
                 (hidden, hidden))
        _check(f"gru[{k!r}]", gru[k], shape, dev)
    return p, hidden


def _weight_ptrs(msg_w, msg_b, gru):
    return [msg_w.data_ptr(), msg_b.data_ptr()] + [
        gru[k].data_ptr() for k in GRU_KEYS]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def fused_ggnn(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """K1: run n_layers GGNN layers over packed tiles.

    h0 (P, T, H); adj (P, T, 4T) flat layout (``adj_from_coo_flat``);
    msg_w (L, 4, H, H); msg_b (L, 4, H); gru: wz/wr/wn (2H, H),
    uz/ur/un (H, H), bz/br/bn (H,).  Returns (P, T, H)."""
    if h0.device.type == "cpu":
        return fused_ggnn_reference(n_layers, h0, adj, msg_w, msg_b, gru)
    from gcnbmp_tpu_torch.ops.build import load_library

    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    lib = load_library()
    out = torch.empty_like(h0)
    with torch.cuda.device(h0.device):  # launch in the tensors' context
        err = lib.fused_ggnn_fwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            out.data_ptr(), p, n_layers, hidden,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_ggnn_fwd")
    fused_ggnn.launches += 1
    return out


fused_ggnn.launches = 0


def fused_ggnn_readout(n_layers: int, h0, adj, msg_w, msg_b, gru,
                       node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    """K2: ``fused_ggnn`` with the gated readout in the same kernel;
    returns g_nodes (P, T, D).  node_mask (P, T) f32; ro_wi (2H, D),
    ro_bi (D,), ro_wj (H, D), ro_bj (D,)."""
    if h0.device.type == "cpu":
        return fused_ggnn_readout_reference(
            n_layers, h0, adj, msg_w, msg_b, gru, node_mask,
            ro_wi, ro_bi, ro_wj, ro_bj)
    from gcnbmp_tpu_torch.ops.build import load_library

    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    d = ro_wj.shape[-1]
    if d != hidden:
        raise ValueError(f"readout width {d} differs from the hidden width "
                         f"{hidden}; the kernel is built for D = H")
    dev = h0.device
    _check("node_mask", node_mask, (p, TILE), dev)
    _check("ro_wi", ro_wi, (2 * hidden, d), dev)
    _check("ro_bi", ro_bi, (d,), dev)
    _check("ro_wj", ro_wj, (hidden, d), dev)
    _check("ro_bj", ro_bj, (d,), dev)
    lib = load_library()
    out = torch.empty((p, TILE, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' context
        err = lib.fused_ggnn_readout_fwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            node_mask.data_ptr(), ro_wi.data_ptr(), ro_bi.data_ptr(),
            ro_wj.data_ptr(), ro_bj.data_ptr(),
            out.data_ptr(), p, n_layers, hidden, d,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "fused_ggnn_readout_fwd")
    fused_ggnn_readout.launches += 1
    return out


fused_ggnn_readout.launches = 0


# ---------------------------------------------------------------------------
# weight conversion


def split_message_kernel(w: torch.Tensor, hidden: int) -> torch.Tensor:
    """(H, 4H) message kernel, (in, out) with edge-fastest columns ->
    per-edge blocks (4, H, H) with W_e[i, c] = W[i, c*4 + e]."""
    return w.reshape(w.shape[0], hidden, NUM_EDGE_TYPE).permute(2, 0, 1)


def split_message_bias(b: torch.Tensor, hidden: int) -> torch.Tensor:
    return b.reshape(hidden, NUM_EDGE_TYPE).T


def params_to_fused(encoder) -> Tuple[torch.Tensor, torch.Tensor,
                                      Dict[str, torch.Tensor]]:
    """The fused kernels' weight format from a ``models.packed.PackedGGNN``:
    msg_w (L, 4, H, H), msg_b (L, 4, H) and the GRU dict with kernels
    (in, out) and the two biases of each gate summed."""
    hidden = encoder.hidden_dim
    ws, bs = [], []
    for l in range(encoder.n_layers):
        dense = encoder.message(l).message.dense
        ws.append(split_message_kernel(dense.weight.T, hidden))
        bs.append(split_message_bias(dense.bias, hidden))
    g = encoder.gru
    gru = {
        "wz": g.W_z.weight.T, "uz": g.U_z.weight.T, "bz": g.W_z.bias + g.U_z.bias,
        "wr": g.W_r.weight.T, "ur": g.U_r.weight.T, "br": g.W_r.bias + g.U_r.bias,
        "wn": g.W.weight.T, "un": g.U.weight.T, "bn": g.W.bias + g.U.bias,
    }
    return (torch.stack(ws).contiguous(), torch.stack(bs).contiguous(),
            {k: v.contiguous() for k, v in gru.items()})
