"""Fused multi-layer GGNN over packed 128-atom tiles, forward and backward.

Port of the kernels of gcnbmp_tpu/ops/fused_ggnn.py:

- ``fused_ggnn``              (K1)  <- ``fused_ggnn`` / ``_fwd_kernel``
- ``fused_ggnn_mid``          (K1m) <- ``_fused_ggnn_fwd``'s TWOPASS branch /
  ``_fwd_mid_kernel``: K1 that also returns h_mid, the input of layer
  ``split = L // 2``
- ``fused_ggnn_readout``      (K2)  <- ``fused_ggnn_readout`` / ``_fwd_readout_kernel``
- ``fused_ggnn_bwd``          (K1b) <- ``_fused_ggnn_bwd`` / ``_bwd_kernel``
- ``fused_ggnn_half_bwd``     (K3)  <- ``_half_bwd_call`` / ``_bwd_half_kernel``:
  K1b over a layer range [lo, hi)
- ``fused_ggnn_readout_bwd``  (K2b) <- ``_fused_ggnn_readout_bwd`` /
  ``_bwd_readout_kernel``

Per layer (semantics of the packed GGNN stack):

    hw_e = h @ W_e + b_e                      (per edge type e = 0..3)
    m    = A_flat (T, 4T) @ [hw_0; ...; hw_3] (4T, H)
    z    = sigmoid(x Wz + s Uz + bz),  x = [h, m]
    r    = sigmoid(x Wr + s Ur + br)
    n    = tanh(x Wn + (r*s) Un + bn)
    h'   = z*n + (1-z)*s                      s = 0 at layer 0, else h

K2 ends with the gated readout ``sigmoid([h, h0] Wi + bi) * (h Wj + bj) *
mask``.  ``fused_ggnn`` and ``fused_ggnn_readout`` are differentiable:
they run through ``FusedGGNNFunction`` and ``FusedGGNNReadoutFunction``
(the ports of the custom VJPs ``fused_ggnn.defvjp`` and
``fused_ggnn_readout.defvjp``), whose backward recomputes the layers from
the saved inputs, as the TPU kernels do; like the JAX VJPs, they are
differentiable once.

``TWOPASS`` (``GCNBMP_FUSED_TWOPASS=1``, the JAX name and meaning, read
at call time so it can be set on the module) splits ``fused_ggnn``'s
backward in two, as ``_fused_ggnn_bwd_twopass`` does: the forward runs
K1m and keeps h_mid; the backward runs K3 over the top half [split, L)
from h_mid and dh, hands dh_mid over in device memory, then runs K3 over
the bottom half [0, split) from h0.  The gradients are the top half's
plus the bottom half's, in that order, with no atomics, so a run repeats
bit for bit.  Each half's recompute scratch is half of K1b's.  With L = 1
the flag is ignored, as in JAX; with no gradient needed the forward runs
K1, since h_mid serves only the backward.  ``fused_ggnn_readout`` (K2)
has no two-pass form, as in JAX.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU; for a CUDA tensor it launches the hand-written Hopper
kernel (``csrc/fused_ggnn.cu``, ``csrc/fused_ggnn_bwd.cu``) or raises.
The kernels, forward (K1, K1m, K2) and reverse (K1b, K3, K2b), are built
for H in ``KERNEL_HIDDEN`` (16, 32, 64, 128).  At H=64 and 128 they run
bodies of their own (``csrc/fused_ggnn64.cuh``, ``csrc/fused_ggnn128.cuh``
and, reverse, ``csrc/fused_ggnn128_bwd.cuh``), which copy the weights in
16-byte pieces, so those must start on 16-byte boundaries.
Each counts its kernel launches in the ``launches`` attribute of
``fused_ggnn``, ``fused_ggnn_mid``, ``fused_ggnn_readout``,
``fused_ggnn_bwd``, ``fused_ggnn_half_bwd`` and
``fused_ggnn_readout_bwd``; the autograd functions count the calls of
their backward in ``backward_calls``.

The JAX package's other TPU A/B knobs are not ported: AGG_KBATCH,
MERGE_GATES, MATMUL_BF16 and GCNBMP_FUSED_BWD_K select among equivalent
forms, precisions or block sizes of the same math on the TPU.  Adjacency
is taken in f32.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gcnbmp_tpu_torch.ops.build import load_library

TILE = 128
NUM_EDGE_TYPE = 4
# widths the kernels' shared-memory plans, forward and reverse, are
# instantiated for; the readout width D equals H
KERNEL_HIDDEN = (16, 32, 64, 128)
# widths whose bodies stream the weights through staged panels
# (csrc/fused_ggnn64.cuh, csrc/fused_ggnn128.cuh) instead of holding them
# in shared memory
PANEL_HIDDEN = (64, 128)
GRU_KEYS = ("wz", "uz", "bz", "wr", "ur", "br", "wn", "un", "bn")
# the two-pass backward (K1m + K3); FusedGGNNFunction reads it per call
TWOPASS = os.environ.get("GCNBMP_FUSED_TWOPASS") == "1"


def gru_shape(key: str, hidden: int) -> Tuple[int, ...]:
    return ((hidden,) if key.startswith("b") else
            (2 * hidden, hidden) if key.startswith("w") else
            (hidden, hidden))


# ---------------------------------------------------------------------------
# plain versions: forward


def _layer_parts(h, state, adj, wmsg, bmsg, gru):
    """One layer: (h', (x, z, r, n)), as the JAX ``_layer_fwd``."""
    hw = torch.cat([h @ wmsg[e] + bmsg[e] for e in range(NUM_EDGE_TYPE)],
                   dim=1)                                  # (P, 4T, H)
    m = torch.bmm(adj, hw)                                 # (P, T, H)
    x = torch.cat([h, m], dim=-1)
    z = torch.sigmoid(x @ gru["wz"] + state @ gru["uz"] + gru["bz"])
    r = torch.sigmoid(x @ gru["wr"] + state @ gru["ur"] + gru["br"])
    n = torch.tanh(x @ gru["wn"] + (r * state) @ gru["un"] + gru["bn"])
    return z * n + (1.0 - z) * state, (x, z, r, n)


def _forward_layers(n_layers, h0, adj, msg_w, msg_b, gru, lo=0):
    """Layers [lo, n_layers) from ``h0``, the input of layer lo: the final
    h and the input of each layer of the range.  The GRU state is zero at
    layer 0 only; at lo > 0 it is the layer's input itself."""
    h = h0
    state = torch.zeros_like(h0) if lo == 0 else h0
    inputs = []
    for l in range(lo, n_layers):
        inputs.append(h)
        h, _ = _layer_parts(h, state, adj, msg_w[l], msg_b[l], gru)
        state = h
    return h, inputs


def fused_ggnn_reference(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """Plain PyTorch K1 (same math as the JAX ``_layer_fwd``)."""
    return _forward_layers(n_layers, h0, adj, msg_w, msg_b, gru)[0]


def fused_ggnn_mid_reference(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """Plain PyTorch K1m: (h, h_mid), h_mid the input of layer
    ``n_layers // 2`` (``_fwd_mid_kernel``); n_layers >= 2."""
    h, inputs = _forward_layers(n_layers, h0, adj, msg_w, msg_b, gru)
    return h, inputs[n_layers // 2]


def readout_reference(h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    gate = torch.sigmoid(torch.cat([h, h0], dim=-1) @ ro_wi + ro_bi)
    return gate * (h @ ro_wj + ro_bj) * node_mask[..., None]


def fused_ggnn_readout_reference(n_layers: int, h0, adj, msg_w, msg_b, gru,
                                 node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    """Plain PyTorch K2 (same math as the JAX ``_readout_fwd``)."""
    h = fused_ggnn_reference(n_layers, h0, adj, msg_w, msg_b, gru)
    return readout_reference(h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj)


# ---------------------------------------------------------------------------
# plain versions: backward, in closed form


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _reverse_layers_reference(n_layers, dh, inputs, adj, msg_w, msg_b, gru,
                              lo=0):
    """Port of ``_reverse_layers`` (fused_ggnn.py:266-370, the AGG_FLAT
    message backward) over layers [lo, n_layers): dh at the top of the
    range in; dh at its bottom (dh0 for lo == 0; for lo > 0 it keeps the
    state term, since layer lo's input is also its state) and the weight
    gradients out, zero outside the range.  ``inputs[l - lo]`` is layer
    l's input h."""
    hidden = dh.shape[-1]
    dmsg_w = torch.zeros_like(msg_w)
    dmsg_b = torch.zeros_like(msg_b)
    dgru = {k: torch.zeros_like(gru[k]) for k in GRU_KEYS}
    adj_t = adj.transpose(1, 2)                            # (P, 4T, T)
    for l in range(n_layers - 1, lo - 1, -1):
        h_in = inputs[l - lo]
        state = torch.zeros_like(h_in) if l == 0 else h_in
        _, (x, z, r, n) = _layer_parts(h_in, state, adj, msg_w[l], msg_b[l],
                                       gru)
        dz = dh * (n - state)
        dn = dh * z
        dstate = dh * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dz_pre = dz * z * (1.0 - z)
        drs = dn_pre @ gru["un"].T
        dr_pre = drs * state * r * (1.0 - r)
        dstate = dstate + drs * r
        dx = (dz_pre @ gru["wz"].T + dr_pre @ gru["wr"].T
              + dn_pre @ gru["wn"].T)
        dh_in, dm = dx[..., :hidden], dx[..., hidden:]
        dstate = dstate + dz_pre @ gru["uz"].T + dr_pre @ gru["ur"].T
        for key, left, right in (("wz", x, dz_pre), ("wr", x, dr_pre),
                                 ("wn", x, dn_pre), ("uz", state, dz_pre),
                                 ("ur", state, dr_pre),
                                 ("un", r * state, dn_pre)):
            dgru[key] += _rows(left).T @ _rows(right)
        for key, d in (("bz", dz_pre), ("br", dr_pre), ("bn", dn_pre)):
            dgru[key] += _rows(d).sum(0)
        dhw = torch.bmm(adj_t, dm)                         # (P, 4T, H)
        for e in range(NUM_EDGE_TYPE):
            dhw_e = dhw[:, e * TILE:(e + 1) * TILE]
            dmsg_w[l, e] = _rows(h_in).T @ _rows(dhw_e)
            dmsg_b[l, e] = _rows(dhw_e).sum(0)
            dh_in = dh_in + dhw_e @ msg_w[l, e].T
        # layer l's input is also its state for l >= 1; layer 0's is zero
        dh = dh_in + dstate if l > 0 else dh_in
    return dh, dmsg_w, dmsg_b, dgru


def fused_ggnn_bwd_reference(n_layers: int, h0, adj, msg_w, msg_b, gru,
                             dh_final):
    """Plain PyTorch K1b: (dh0, dmsg_w, dmsg_b, dgru) for the upstream
    gradient dh_final of ``fused_ggnn``'s output (recompute as in
    ``_bwd_kernel``, then ``_reverse_layers``)."""
    _, inputs = _forward_layers(n_layers, h0, adj, msg_w, msg_b, gru)
    return _reverse_layers_reference(n_layers, dh_final, inputs, adj, msg_w,
                                     msg_b, gru)


def fused_ggnn_half_bwd_reference(lo: int, hi: int, hin, adj, msg_w, msg_b,
                                  gru, dh_top):
    """Plain PyTorch K3 (``_bwd_half_kernel``): the backward over layers
    [lo, hi) from hin (h0 for lo == 0, else the input of layer lo) and
    dh_top; returns (dh_bot, dmsg_w, dmsg_b, dgru) with the message
    gradients zero outside [lo, hi)."""
    _, inputs = _forward_layers(hi, hin, adj, msg_w, msg_b, gru, lo=lo)
    return _reverse_layers_reference(hi, dh_top, inputs, adj, msg_w, msg_b,
                                     gru, lo=lo)


def readout_bwd_reference(h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dg):
    """The gated readout's backward (``_bwd_readout_kernel``, :749-765):
    (dh, dh0_direct, dwi, dbi, dwj, dbj)."""
    hidden = h.shape[-1]
    pre_cat = torch.cat([h, h0], dim=-1)
    gate = torch.sigmoid(pre_cat @ ro_wi + ro_bi)
    out_j = h @ ro_wj + ro_bj
    mask = node_mask[..., None]
    dgate = dg * out_j * mask
    dout_j = dg * gate * mask
    dpre_i = dgate * gate * (1.0 - gate)
    dcat = dpre_i @ ro_wi.T                                # (P, T, 2H)
    dh = dcat[..., :hidden] + dout_j @ ro_wj.T
    return (dh, dcat[..., hidden:],
            _rows(pre_cat).T @ _rows(dpre_i), _rows(dpre_i).sum(0),
            _rows(h).T @ _rows(dout_j), _rows(dout_j).sum(0))


def fused_ggnn_readout_bwd_reference(n_layers: int, h0, adj, msg_w, msg_b,
                                     gru, node_mask, ro_wi, ro_bi, ro_wj,
                                     ro_bj, dg):
    """Plain PyTorch K2b: (dh0, dmsg_w, dmsg_b, dgru, dwi, dbi, dwj, dbj)
    for the upstream gradient dg of ``fused_ggnn_readout``'s output.  dh0
    includes the readout's direct h0 term (fused_ggnn.py:765, :773)."""
    h, inputs = _forward_layers(n_layers, h0, adj, msg_w, msg_b, gru)
    dh, dh0_direct, dwi, dbi, dwj, dbj = readout_bwd_reference(
        h, h0, node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dg)
    dh0, dmsg_w, dmsg_b, dgru = _reverse_layers_reference(
        n_layers, dh, inputs, adj, msg_w, msg_b, gru)
    return dh0 + dh0_direct, dmsg_w, dmsg_b, dgru, dwi, dbi, dwj, dbj


# ---------------------------------------------------------------------------
# kernel wrappers


def _check(name: str, x: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_width(hidden: int) -> None:
    """Raise unless the kernels are built for hidden width ``hidden``."""
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"hidden width {hidden} is not one the kernel's "
                         f"shared-memory plan holds {KERNEL_HIDDEN}; other "
                         f'widths are ROADMAP queue 2, "Open: hidden widths"')


def _check_common(n_layers, h0, adj, msg_w, msg_b, gru):
    if h0.device.type != "cuda":
        raise RuntimeError(f"fused GGNN kernels run on CUDA or CPU tensors, "
                           f"got {h0.device}")
    p, t, hidden = h0.shape
    if t != TILE:
        raise ValueError(f"tiles must hold {TILE} atoms, got {t}")
    check_width(hidden)
    if n_layers < 1 or msg_w.shape[0] != n_layers:
        raise ValueError(f"n_layers={n_layers} but msg_w has "
                         f"{msg_w.shape[0]} layers")
    dev = h0.device
    _check("h0", h0, (p, TILE, hidden), dev)
    _check("adj", adj, (p, TILE, NUM_EDGE_TYPE * TILE), dev)
    _check("msg_w", msg_w, (n_layers, NUM_EDGE_TYPE, hidden, hidden), dev)
    _check("msg_b", msg_b, (n_layers, NUM_EDGE_TYPE, hidden), dev)
    for k in GRU_KEYS:
        _check(f"gru[{k!r}]", gru[k], gru_shape(k, hidden), dev)
    if hidden in PANEL_HIDDEN:
        _check_aligned(msg_w=msg_w, **{k: gru[k] for k in GRU_KEYS if k[0] != "b"})
    return p, hidden


def _check_aligned(**weights) -> None:
    """The panel bodies copy their weight blocks with 16-byte cp.async."""
    for name, x in weights.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary at "
                             f"hidden width {PANEL_HIDDEN}")


def _check_readout(p, hidden, node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dev):
    d = ro_wj.shape[-1]
    if d != hidden:
        raise ValueError(f"readout width {d} differs from the hidden width "
                         f"{hidden}; the kernels are built for D = H")
    _check("node_mask", node_mask, (p, TILE), dev)
    _check("ro_wi", ro_wi, (2 * hidden, d), dev)
    _check("ro_bi", ro_bi, (d,), dev)
    _check("ro_wj", ro_wj, (hidden, d), dev)
    _check("ro_bj", ro_bj, (d,), dev)
    if hidden in PANEL_HIDDEN:
        _check_aligned(ro_wi=ro_wi, ro_wj=ro_wj)
    return d


def _weight_ptrs(msg_w, msg_b, gru):
    return [msg_w.data_ptr(), msg_b.data_ptr()] + [
        gru[k].data_ptr() for k in GRU_KEYS]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {err}")


def _stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream (no stream object is
    built for it)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_SAME_DEVICE = contextlib.nullcontext()


def _on_device(device: torch.device):
    """What a launch on ``device``'s tensors runs in: ``device`` made the
    current CUDA device, or nothing when it is the current one."""
    if device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def _fused_ggnn_fwd(n_layers, h0, adj, msg_w, msg_b, gru):
    """K1 on the tensors' device (plain version on the CPU)."""
    if h0.device.type == "cpu":
        return fused_ggnn_reference(n_layers, h0, adj, msg_w, msg_b, gru)
    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    lib = load_library()
    out = torch.empty_like(h0)
    with _on_device(h0.device):
        err = lib.fused_ggnn_fwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            out.data_ptr(), p, n_layers, hidden, _stream(h0.device))
    _raise_on(err, "fused_ggnn_fwd")
    fused_ggnn.launches += 1
    return out


def fused_ggnn_mid(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """K1m: (h, h_mid) on the tensors' device (plain version on the CPU),
    h_mid the input of layer ``n_layers // 2``; n_layers >= 2.  h is bit
    for bit K1's."""
    if h0.device.type == "cpu":
        return fused_ggnn_mid_reference(n_layers, h0, adj, msg_w, msg_b, gru)
    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    if n_layers < 2:
        raise ValueError("K1m needs two layers or more to split")
    lib = load_library()
    out = torch.empty_like(h0)
    mid = torch.empty_like(h0)
    with _on_device(h0.device):
        err = lib.fused_ggnn_mid_fwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            out.data_ptr(), mid.data_ptr(), p, n_layers, n_layers // 2,
            hidden, _stream(h0.device))
    _raise_on(err, "fused_ggnn_mid_fwd")
    fused_ggnn_mid.launches += 1
    return out, mid


fused_ggnn_mid.launches = 0


def _fused_ggnn_readout_fwd(n_layers, h0, adj, msg_w, msg_b, gru, node_mask,
                            ro_wi, ro_bi, ro_wj, ro_bj):
    """K2 on the tensors' device (plain version on the CPU)."""
    if h0.device.type == "cpu":
        return fused_ggnn_readout_reference(
            n_layers, h0, adj, msg_w, msg_b, gru, node_mask,
            ro_wi, ro_bi, ro_wj, ro_bj)
    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    dev = h0.device
    d = _check_readout(p, hidden, node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dev)
    lib = load_library()
    out = torch.empty((p, TILE, d), dtype=torch.float32, device=dev)
    with _on_device(dev):
        err = lib.fused_ggnn_readout_fwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            node_mask.data_ptr(), ro_wi.data_ptr(), ro_bi.data_ptr(),
            ro_wj.data_ptr(), ro_bj.data_ptr(),
            out.data_ptr(), p, n_layers, hidden, d, _stream(dev))
    _raise_on(err, "fused_ggnn_readout_fwd")
    fused_ggnn_readout.launches += 1
    return out


def _grad_shapes(n_layers: int, hidden: int,
                 d: Optional[int] = None) -> List[Tuple[int, ...]]:
    """The order of the backward kernels' summed gradient row
    (``GradLayout`` in csrc/fused_ggnn_bwd.cu)."""
    shapes = [(n_layers, NUM_EDGE_TYPE, hidden, hidden),
              (n_layers, NUM_EDGE_TYPE, hidden)]
    shapes += [gru_shape(k, hidden) for k in GRU_KEYS]
    if d is not None:
        shapes += [(2 * hidden, d), (d,), (hidden, d), (d,)]
    return shapes


def _bwd_buffers(p, n_layers, hidden, d, dev):
    """The backward kernels' output dh and scratch: the tiles' gradient
    rows, their sum, each layer's input hs and, at H=128, each layer's
    stored m, r, z and n (``acts``, which the reverse reads in place of
    rebuilding the forward; None at the narrower widths)."""
    shapes = _grad_shapes(n_layers, hidden, d)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    n_grad = sum(sizes)
    f32 = dict(dtype=torch.float32, device=dev)
    dh0 = torch.empty((p, TILE, hidden), **f32)
    partial = torch.empty((p, n_grad), **f32)
    grads = torch.empty((n_grad,), **f32)
    hs = torch.empty((p, n_layers, TILE, hidden), **f32)
    acts = (torch.empty((p, n_layers, 4, TILE, hidden), **f32)
            if hidden == 128 else None)
    return dh0, partial, grads, hs, acts, shapes, sizes


def _ptr(x):
    """A tensor's address for the C entry points, NULL for None."""
    return None if x is None else x.data_ptr()


def _split_grads(grads, shapes, sizes):
    parts = [g.view(s) for g, s in zip(grads.split(sizes), shapes)]
    dgru = dict(zip(GRU_KEYS, parts[2:2 + len(GRU_KEYS)]))
    return parts[0], parts[1], dgru, parts[2 + len(GRU_KEYS):]


def _range_bwd(lo: int, hi: int, hin, adj, msg_w, msg_b, gru, dh_top):
    """Launch the backward kernel over layers [lo, hi) of the
    msg_w.shape[0]-layer stack on CUDA tensors (K1b for [0, L), each half
    of K3 otherwise): (dh_bot, the range's dmsg_w and dmsg_b, dgru)."""
    n_layers = msg_w.shape[0]
    p, hidden = _check_common(n_layers, hin, adj, msg_w, msg_b, gru)
    if not 0 <= lo < hi <= n_layers:
        raise ValueError(f"layer range [{lo}, {hi}) outside [0, {n_layers})")
    dev = hin.device
    _check("dh_top", dh_top, (p, TILE, hidden), dev)
    lib = load_library()
    dh_bot, partial, grads, hs, acts, shapes, sizes = _bwd_buffers(
        p, hi - lo, hidden, None, dev)
    with _on_device(dev):
        err = lib.fused_ggnn_range_bwd(
            hin.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            dh_top.data_ptr(), dh_bot.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), hs.data_ptr(), _ptr(acts), p, lo, hi, hidden,
            _stream(dev))
    _raise_on(err, "fused_ggnn_range_bwd")
    dmsg_w, dmsg_b, dgru, _ = _split_grads(grads, shapes, sizes)
    return dh_bot, dmsg_w, dmsg_b, dgru


def fused_ggnn_bwd(n_layers: int, h0, adj, msg_w, msg_b, gru, dh_final):
    """K1b: (dh0, dmsg_w, dmsg_b, dgru) for the upstream gradient dh_final
    (P, T, H) of ``fused_ggnn``'s output."""
    if h0.device.type == "cpu":
        return fused_ggnn_bwd_reference(n_layers, h0, adj, msg_w, msg_b, gru,
                                        dh_final)
    if msg_w.shape[0] != n_layers:
        raise ValueError(f"n_layers={n_layers} but msg_w has "
                         f"{msg_w.shape[0]} layers")
    out = _range_bwd(0, n_layers, h0, adj, msg_w, msg_b, gru, dh_final)
    fused_ggnn_bwd.launches += 1
    return out


fused_ggnn_bwd.launches = 0


def fused_ggnn_half_bwd(lo: int, hi: int, hin, adj, msg_w, msg_b, gru,
                        dh_top):
    """K3: the backward over layers [lo, hi) of the msg_w.shape[0]-layer
    stack, from hin (h0 for lo == 0, else the input of layer lo, h_mid)
    and dh_top (P, T, H), the gradient of layer hi-1's output.  Returns
    (dh_bot, dmsg_w, dmsg_b, dgru): dh_bot is the gradient of layer lo's
    input; the message gradients have the full (L, ...) shapes, zero
    outside [lo, hi), as ``_half_bwd_call``'s outputs."""
    if hin.device.type == "cpu":
        return fused_ggnn_half_bwd_reference(lo, hi, hin, adj, msg_w, msg_b,
                                             gru, dh_top)
    dh_bot, half_w, half_b, dgru = _range_bwd(lo, hi, hin, adj, msg_w, msg_b,
                                              gru, dh_top)
    fused_ggnn_half_bwd.launches += 1
    dmsg_w = torch.zeros_like(msg_w)
    dmsg_b = torch.zeros_like(msg_b)
    dmsg_w[lo:hi] = half_w
    dmsg_b[lo:hi] = half_b
    return dh_bot, dmsg_w, dmsg_b, dgru


fused_ggnn_half_bwd.launches = 0


def fused_ggnn_readout_bwd(n_layers: int, h0, adj, msg_w, msg_b, gru,
                           node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dg):
    """K2b: (dh0, dmsg_w, dmsg_b, dgru, dwi, dbi, dwj, dbj) for the
    upstream gradient dg (P, T, D) of ``fused_ggnn_readout``'s output."""
    if h0.device.type == "cpu":
        return fused_ggnn_readout_bwd_reference(
            n_layers, h0, adj, msg_w, msg_b, gru, node_mask,
            ro_wi, ro_bi, ro_wj, ro_bj, dg)
    p, hidden = _check_common(n_layers, h0, adj, msg_w, msg_b, gru)
    dev = h0.device
    d = _check_readout(p, hidden, node_mask, ro_wi, ro_bi, ro_wj, ro_bj, dev)
    _check("dg", dg, (p, TILE, d), dev)
    lib = load_library()
    dh0, partial, grads, hs, acts, shapes, sizes = _bwd_buffers(
        p, n_layers, hidden, d, dev)
    with _on_device(dev):
        err = lib.fused_ggnn_readout_bwd(
            h0.data_ptr(), adj.data_ptr(), *_weight_ptrs(msg_w, msg_b, gru),
            node_mask.data_ptr(), ro_wi.data_ptr(), ro_bi.data_ptr(),
            ro_wj.data_ptr(), ro_bj.data_ptr(),
            dg.data_ptr(), dh0.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), hs.data_ptr(), _ptr(acts), p, n_layers, hidden, d,
            _stream(dev))
    _raise_on(err, "fused_ggnn_readout_bwd")
    fused_ggnn_readout_bwd.launches += 1
    dmsg_w, dmsg_b, dgru, (dwi, dbi, dwj, dbj) = _split_grads(
        grads, shapes, sizes)
    return dh0, dmsg_w, dmsg_b, dgru, dwi, dbi, dwj, dbj


fused_ggnn_readout_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd


def fused_ggnn_twopass_bwd(n_layers: int, h0, h_mid, adj, msg_w, msg_b, gru,
                           dh_final):
    """The two-pass backward (``_fused_ggnn_bwd_twopass``): K3 over the
    top half [split, L) from h_mid, then over the bottom half [0, split)
    from h0 with the top half's dh_mid; the gradients summed top +
    bottom, in that order."""
    split = n_layers // 2
    dh_mid, tw, tb, tgru = fused_ggnn_half_bwd(
        split, n_layers, h_mid, adj, msg_w, msg_b, gru, dh_final)
    dh0, bw, bb, bgru = fused_ggnn_half_bwd(
        0, split, h0, adj, msg_w, msg_b, gru, dh_mid)
    return dh0, tw + bw, tb + bb, {k: tgru[k] + bgru[k] for k in GRU_KEYS}


class FusedGGNNFunction(torch.autograd.Function):
    """K1 forward, K1b backward: the port of ``fused_ggnn.defvjp``
    (fused_ggnn.py:669).  Saves the inputs, not activations; under
    ``TWOPASS`` (n_layers > 1) the forward is K1m, which also saves h_mid,
    and the backward is ``fused_ggnn_twopass_bwd`` (K3 twice)."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, n_layers, h0, adj, msg_w, msg_b, *gru_values):
        ctx.n_layers = n_layers
        gru = dict(zip(GRU_KEYS, gru_values))
        if TWOPASS and n_layers > 1 and any(ctx.needs_input_grad):
            h, h_mid = fused_ggnn_mid(n_layers, h0, adj, msg_w, msg_b, gru)
            ctx.save_for_backward(h0, adj, msg_w, msg_b, h_mid, *gru_values)
            ctx.twopass = True
            return h
        ctx.save_for_backward(h0, adj, msg_w, msg_b, *gru_values)
        ctx.twopass = False
        return _fused_ggnn_fwd(n_layers, h0, adj, msg_w, msg_b, gru)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        FusedGGNNFunction.backward_calls += 1
        if ctx.twopass:
            h0, adj, msg_w, msg_b, h_mid, *gru_values = ctx.saved_tensors
            dh0, dmsg_w, dmsg_b, dgru = fused_ggnn_twopass_bwd(
                ctx.n_layers, h0, h_mid, adj, msg_w, msg_b,
                dict(zip(GRU_KEYS, gru_values)), dh.contiguous())
        else:
            h0, adj, msg_w, msg_b, *gru_values = ctx.saved_tensors
            dh0, dmsg_w, dmsg_b, dgru = fused_ggnn_bwd(
                ctx.n_layers, h0, adj, msg_w, msg_b,
                dict(zip(GRU_KEYS, gru_values)), dh.contiguous())
        return (None, dh0, None, dmsg_w, dmsg_b,
                *(dgru[k] for k in GRU_KEYS))


class FusedGGNNReadoutFunction(torch.autograd.Function):
    """K2 forward, K2b backward: the port of ``fused_ggnn_readout.defvjp``
    (fused_ggnn.py:896).  Saves the inputs, not activations."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, n_layers, h0, adj, msg_w, msg_b, node_mask, ro_wi, ro_bi,
                ro_wj, ro_bj, *gru_values):
        ctx.n_layers = n_layers
        ctx.save_for_backward(h0, adj, msg_w, msg_b, node_mask, ro_wi, ro_bi,
                              ro_wj, ro_bj, *gru_values)
        return _fused_ggnn_readout_fwd(
            n_layers, h0, adj, msg_w, msg_b, dict(zip(GRU_KEYS, gru_values)),
            node_mask, ro_wi, ro_bi, ro_wj, ro_bj)

    @staticmethod
    @once_differentiable
    def backward(ctx, dg):
        FusedGGNNReadoutFunction.backward_calls += 1
        (h0, adj, msg_w, msg_b, node_mask, ro_wi, ro_bi, ro_wj, ro_bj,
         *gru_values) = ctx.saved_tensors
        dh0, dmsg_w, dmsg_b, dgru, dwi, dbi, dwj, dbj = fused_ggnn_readout_bwd(
            ctx.n_layers, h0, adj, msg_w, msg_b,
            dict(zip(GRU_KEYS, gru_values)), node_mask,
            ro_wi, ro_bi, ro_wj, ro_bj, dg.contiguous())
        return (None, dh0, None, dmsg_w, dmsg_b, None, dwi, dbi, dwj, dbj,
                *(dgru[k] for k in GRU_KEYS))


def fused_ggnn(n_layers: int, h0, adj, msg_w, msg_b, gru):
    """K1: run n_layers GGNN layers over packed tiles; differentiable in
    h0 and the weights (K1b).

    h0 (P, T, H); adj (P, T, 4T) flat layout (``adj_from_coo_flat``);
    msg_w (L, 4, H, H); msg_b (L, 4, H); gru: wz/wr/wn (2H, H),
    uz/ur/un (H, H), bz/br/bn (H,).  Returns (P, T, H)."""
    return FusedGGNNFunction.apply(n_layers, h0, adj, msg_w, msg_b,
                                   *(gru[k] for k in GRU_KEYS))


fused_ggnn.launches = 0


def fused_ggnn_readout(n_layers: int, h0, adj, msg_w, msg_b, gru,
                       node_mask, ro_wi, ro_bi, ro_wj, ro_bj):
    """K2: ``fused_ggnn`` with the gated readout in the same kernel;
    returns g_nodes (P, T, D); differentiable in h0 and the weights (K2b).
    node_mask (P, T) f32; ro_wi (2H, D), ro_bi (D,), ro_wj (H, D),
    ro_bj (D,)."""
    return FusedGGNNReadoutFunction.apply(
        n_layers, h0, adj, msg_w, msg_b, node_mask, ro_wi, ro_bi, ro_wj,
        ro_bj, *(gru[k] for k in GRU_KEYS))


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
