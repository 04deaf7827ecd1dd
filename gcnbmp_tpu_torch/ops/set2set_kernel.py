"""Fused Set2Set readout: all processing steps in one kernel, forward and
backward.

Port of gcnbmp_tpu/ops/set2set_kernel.py:

- ``fused_set2set``     (K4)  <- ``fused_set2set`` / ``_fwd_kernel``, ``_step_fwd``
- ``fused_set2set_bwd`` (K4b) <- ``_fused_set2set_bwd`` / ``_bwd_kernel`` and
  its epilogue (:279-286), which here is part of the kernel

Each of the S steps, over a (M, n_max, C) atom table with its (M, n_max)
mask, with c, hh and q* starting at 0 (the LSTM is flax's
``OptimizedLSTMCell``: gate order i|f|g|o, bias-free input kernels wx
(2C, 4C), biased hidden kernels wh (C, 4C), b (1, 4C)):

    y = q* wx + hh wh + b;  i, f, o = sigmoid, g = tanh
    c = f c + i g;  q = o tanh(c);  hh = q
    e = atoms . q, -1e9 where amask = 0;  p = softmax over n_max
    r = sum_n (p amask)_n atoms_n;  q* = [q, r]

A molecule with no atoms (pair padding) gets a uniform p, r = 0 and no
NaN, as in the JAX package.  ``fused_set2set`` is differentiable in atoms
and the weights through ``FusedSet2SetFunction`` (the port of
``fused_set2set.defvjp``); amask gets no gradient.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU; for a CUDA tensor it launches the hand-written Hopper
kernel (``csrc/set2set.cu``) or raises.  Launches are counted in
``fused_set2set.launches`` and ``fused_set2set_bwd.launches``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from gcnbmp_tpu_torch.ops.fused_ggnn import _check, _raise_on, _stream

NEG = -1e9
# what the kernels hold per warp: channels, atoms per molecule, steps
KERNEL_HIDDEN = (16, 32)
KERNEL_MAX_ATOMS = 128
KERNEL_MAX_STEPS = 4


# ---------------------------------------------------------------------------
# plain versions


def _step(atoms, amask, wx, wh, b, c, hh, q_star):
    """One processing step (``_step_fwd``): (c', q, gates, p, q*')."""
    ch = wh.shape[0]
    y = q_star @ wx + hh @ wh + b
    i = torch.sigmoid(y[:, :ch])
    f = torch.sigmoid(y[:, ch:2 * ch])
    g = torch.tanh(y[:, 2 * ch:3 * ch])
    o = torch.sigmoid(y[:, 3 * ch:])
    c_new = f * c + i * g
    q = o * torch.tanh(c_new)
    e = (atoms * q[:, None, :]).sum(-1)
    em = torch.where(amask > 0, e, torch.full_like(e, NEG))
    p = torch.softmax(em, dim=1)
    r = ((p * amask)[:, :, None] * atoms).sum(1)
    return c_new, q, (i, f, g, o), p, torch.cat([q, r], dim=-1)


def _forward_steps(steps, atoms, amask, wx, wh, b):
    m, ch = atoms.shape[0], wh.shape[0]
    c = atoms.new_zeros((m, ch))
    hh = atoms.new_zeros((m, ch))
    q_star = atoms.new_zeros((m, 2 * ch))
    trace = []
    for _ in range(steps):
        c_prev, qs_in = c, q_star
        c, q, gates, p, q_star = _step(atoms, amask, wx, wh, b, c, hh, q_star)
        hh = q
        trace.append((c_prev, c, qs_in, q, gates, p))
    return q_star, trace


def fused_set2set_reference(steps: int, atoms, amask, wx, wh, b):
    """Plain PyTorch K4: q* (M, 2C) after ``steps`` steps."""
    return _forward_steps(steps, atoms, amask, wx, wh, b)[0]


def fused_set2set_bwd_reference(steps: int, atoms, amask, wx, wh, b, dg):
    """Plain PyTorch K4b in closed form (``_bwd_kernel`` and its
    epilogue): (datoms, dwx, dwh, db) for the upstream gradient dg
    (M, 2C) of ``fused_set2set``'s output."""
    _, trace = _forward_steps(steps, atoms, amask, wx, wh, b)
    ch = wh.shape[0]
    dq, dr = dg[:, :ch], dg[:, ch:]
    dc = torch.zeros_like(dq)
    dhh = torch.zeros_like(dq)
    datoms = torch.zeros_like(atoms)
    dwx, dwh, db = torch.zeros_like(wx), torch.zeros_like(wh), torch.zeros_like(b)
    for s in range(steps - 1, -1, -1):
        c_prev, c_new, qs_in, q, (i, f, g, o), p = trace[s]
        hh_prev = qs_in[:, :ch]  # the LSTM hidden is the previous q
        # r = sum_n (p amask)_n atoms_n
        da = (atoms * dr[:, None, :]).sum(-1)
        pdp = p * (da * amask)
        de = torch.where(amask > 0, pdp - p * pdp.sum(1, keepdim=True),
                         torch.zeros_like(pdp))
        dq = dq + (de[:, :, None] * atoms).sum(1)
        datoms = datoms + (p * amask)[:, :, None] * dr[:, None, :] \
            + de[:, :, None] * q[:, None, :]
        # q = o tanh(c_new); q is also the next step's hidden
        dq_t = dq + dhh
        tc = torch.tanh(c_new)
        do = dq_t * tc
        dc_new = dq_t * o * (1.0 - tc * tc) + dc
        df = dc_new * c_prev
        dc = dc_new * f
        dy = torch.cat([dc_new * g * i * (1.0 - i), df * f * (1.0 - f),
                        dc_new * i * (1.0 - g * g), do * o * (1.0 - o)],
                       dim=-1)                            # (M, 4C)
        dwx = dwx + qs_in.T @ dy
        dwh = dwh + hh_prev.T @ dy
        db = db + dy.sum(0, keepdim=True)
        dq_star = dy @ wx.T
        dq, dr = dq_star[:, :ch], dq_star[:, ch:]
        dhh = dy @ wh.T
    return datoms, dwx, dwh, db


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_inputs(steps, atoms, amask, wx, wh, b):
    if atoms.device.type != "cuda":
        raise RuntimeError(f"fused Set2Set kernels run on CUDA or CPU "
                           f"tensors, got {atoms.device}")
    m, n_max, ch = atoms.shape
    if ch not in KERNEL_HIDDEN:
        raise ValueError(f"channel width {ch} is not one the kernels are "
                         f"built for {KERNEL_HIDDEN}")
    if not 1 <= n_max <= KERNEL_MAX_ATOMS:
        raise ValueError(f"n_max={n_max} outside the kernels' "
                         f"1..{KERNEL_MAX_ATOMS}")
    if not 1 <= steps <= KERNEL_MAX_STEPS:
        raise ValueError(f"steps={steps} outside the kernels' "
                         f"1..{KERNEL_MAX_STEPS}")
    if m < 1:
        raise ValueError("no molecules")
    dev = atoms.device
    _check("atoms", atoms, (m, n_max, ch), dev)
    _check("amask", amask, (m, n_max), dev)
    _check("wx", wx, (2 * ch, 4 * ch), dev)
    _check("wh", wh, (ch, 4 * ch), dev)
    _check("b", b, (1, 4 * ch), dev)
    return m, n_max, ch


def _fused_set2set_fwd(steps, atoms, amask, wx, wh, b):
    """K4 on the tensors' device (plain version on the CPU)."""
    if atoms.device.type == "cpu":
        return fused_set2set_reference(steps, atoms, amask, wx, wh, b)
    from gcnbmp_tpu_torch.ops.build import load_library

    m, n_max, ch = _check_inputs(steps, atoms, amask, wx, wh, b)
    lib = load_library()
    out = torch.empty((m, 2 * ch), dtype=torch.float32, device=atoms.device)
    with torch.cuda.device(atoms.device):
        err = lib.fused_set2set_fwd(
            atoms.data_ptr(), amask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), out.data_ptr(), m, n_max, ch, steps, _stream())
    _raise_on(err, "fused_set2set_fwd")
    fused_set2set.launches += 1
    return out


def fused_set2set_bwd(steps: int, atoms, amask, wx, wh, b, dg):
    """K4b: (datoms, dwx, dwh, db) for the upstream gradient dg (M, 2C)."""
    if atoms.device.type == "cpu":
        return fused_set2set_bwd_reference(steps, atoms, amask, wx, wh, b, dg)
    from gcnbmp_tpu_torch.ops.build import load_library

    m, n_max, ch = _check_inputs(steps, atoms, amask, wx, wh, b)
    dev = atoms.device
    _check("dg", dg, (m, 2 * ch), dev)
    lib = load_library()
    n_ctas = int(lib.set2set_bwd_ctas(m))
    sizes = [2 * ch * 4 * ch, ch * 4 * ch, 4 * ch]
    f32 = dict(dtype=torch.float32, device=dev)
    datoms = torch.empty_like(atoms)
    partial = torch.empty((n_ctas, sum(sizes)), **f32)
    grads = torch.empty((sum(sizes),), **f32)
    with torch.cuda.device(dev):
        err = lib.fused_set2set_bwd(
            atoms.data_ptr(), amask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), dg.data_ptr(), datoms.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), m, n_max, ch, steps,
            _stream())
    _raise_on(err, "fused_set2set_bwd")
    fused_set2set_bwd.launches += 1
    dwx, dwh, db = grads.split(sizes)
    return (datoms, dwx.view(2 * ch, 4 * ch), dwh.view(ch, 4 * ch),
            db.view(1, 4 * ch))


fused_set2set_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd


class FusedSet2SetFunction(torch.autograd.Function):
    """K4 forward, K4b backward: the port of ``fused_set2set.defvjp``
    (set2set_kernel.py:289).  Saves the inputs; amask gets no gradient."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, steps, atoms, amask, wx, wh, b):
        ctx.steps = steps
        ctx.save_for_backward(atoms, amask, wx, wh, b)
        return _fused_set2set_fwd(steps, atoms, amask, wx, wh, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, dg):
        FusedSet2SetFunction.backward_calls += 1
        atoms, amask, wx, wh, b = ctx.saved_tensors
        datoms, dwx, dwh, db = fused_set2set_bwd(ctx.steps, atoms, amask, wx,
                                                 wh, b, dg.contiguous())
        return None, datoms, None, dwx, dwh, db


def fused_set2set(steps: int, atoms, amask, wx, wh, b):
    """K4: all ``steps`` Set2Set steps; returns q* (M, 2C).
    atoms (M, n_max, C) masked atom table; amask (M, n_max) f32; wx
    (2C, 4C), wh (C, 4C), b (1, 4C) in gate order i|f|g|o."""
    return FusedSet2SetFunction.apply(steps, atoms, amask, wx, wh, b)


fused_set2set.launches = 0
