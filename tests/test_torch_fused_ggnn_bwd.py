"""The backward kernels' plain versions (K1b, K2b) against ``jax.vjp`` of
the JAX package's fused GGNN (Pallas in interpret mode on the CPU, as
tests/test_fused_ggnn.py runs it) and against torch autograd of the plain
forwards; ``gradcheck`` of the autograd functions; the wrappers' CPU
behaviour.  The CUDA kernels are checked against these plain versions on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.ops import fused_ggnn as jfg
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-5  # the JAX suite's gradient bound (test_fused_ggnn.py:87)
L = 3
T = 128
CASES = [(16, True), (16, False), (32, True), (32, False), (64, True), (64, False)]


def _inputs(hidden, tied, p=2, seed=0):
    """K1 inputs, the readout's, and an upstream gradient, in numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    h0 = f32(p, T, hidden)
    adj = (rng.random((p, T, 4 * T)) < 0.01).astype(np.float32)
    n_msg = 1 if tied else L
    msg_w = f32(n_msg, 4, hidden, hidden, scale=hidden ** -0.5)
    msg_b = f32(n_msg, 4, hidden, scale=0.1)
    if tied:
        msg_w, msg_b = np.repeat(msg_w, L, 0), np.repeat(msg_b, L, 0)
    gru = {k: f32(*tfg.gru_shape(k, hidden),
                  scale=0.1 if k[0] == "b" else tfg.gru_shape(k, hidden)[0] ** -0.5)
           for k in tfg.GRU_KEYS}
    readout = [(rng.random((p, T)) < 0.8).astype(np.float32),
               f32(2 * hidden, hidden, scale=(2 * hidden) ** -0.5),
               f32(hidden, scale=0.1), f32(hidden, hidden, scale=hidden ** -0.5),
               f32(hidden, scale=0.1)]
    return [h0, adj, msg_w, msg_b, gru], readout, f32(p, T, hidden)


def _conv(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _flat(grads):
    """Backward results as a flat list, the GRU dict in GRU_KEYS order."""
    out = []
    for g in grads:
        if isinstance(g, dict):
            out += [g[k] for k in tfg.GRU_KEYS]
        elif g is not None:
            out.append(g)
    return [np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g)
            for g in out]


def _close(got, want, what):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} #{i}")


@pytest.mark.parametrize("hidden,tied", CASES)
def test_k1b_plain_matches_jax_vjp(hidden, tied):
    args, _, dh = _inputs(hidden, tied)
    jargs = [_conv(a, jnp.asarray) for a in args]
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda h0, w, b, g: jfg.fused_ggnn(L, h0, jargs[1], w, b, g),
                         jargs[0], *jargs[2:])
        want = vjp(jnp.asarray(dh))
    targs = [_conv(a, torch.as_tensor) for a in args]
    got = tfg.fused_ggnn_bwd_reference(L, *targs, torch.as_tensor(dh))
    _close(_flat(got), _flat(want), f"K1b H={hidden} tied={tied}")


@pytest.mark.parametrize("hidden,tied", CASES)
def test_k2b_plain_matches_jax_vjp(hidden, tied):
    args, readout, dg = _inputs(hidden, tied, seed=1)
    jargs = [_conv(a, jnp.asarray) for a in args]
    jmask, *jro = map(jnp.asarray, readout)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda h0, w, b, g, wi, bi, wj, bj: jfg.fused_ggnn_readout(
                L, h0, jargs[1], w, b, g, jmask, wi, bi, wj, bj),
            jargs[0], *jargs[2:], *jro)
        want = vjp(jnp.asarray(dg))
    targs = [_conv(a, torch.as_tensor) for a in args]
    got = tfg.fused_ggnn_readout_bwd_reference(
        L, *targs, *map(torch.as_tensor, readout), torch.as_tensor(dg))
    _close(_flat(got), _flat(want), f"K2b H={hidden} tied={tied}")


@pytest.mark.parametrize("hidden,tied", CASES)
@pytest.mark.parametrize("readout", [False, True])
def test_plain_backward_matches_torch_autograd(hidden, tied, readout):
    args, ro, dout = _inputs(hidden, tied, seed=2)
    h0, adj, msg_w, msg_b, gru = [_conv(a, torch.as_tensor) for a in args]
    ro = [torch.as_tensor(a) for a in ro]
    wrt = [h0, msg_w, msg_b, *(gru[k] for k in tfg.GRU_KEYS)]
    wrt += ro[1:] if readout else []
    for t in wrt:
        t.requires_grad_(True)
    if readout:
        out = tfg.fused_ggnn_readout_reference(L, h0, adj, msg_w, msg_b, gru, *ro)
    else:
        out = tfg.fused_ggnn_reference(L, h0, adj, msg_w, msg_b, gru)
    want = torch.autograd.grad(out, wrt, torch.as_tensor(dout))
    plain = [t.detach() for t in wrt]
    pgru = dict(zip(tfg.GRU_KEYS, plain[3:12]))
    if readout:
        got = tfg.fused_ggnn_readout_bwd_reference(
            L, plain[0], adj, plain[1], plain[2], pgru, ro[0], *plain[12:],
            torch.as_tensor(dout))
    else:
        got = tfg.fused_ggnn_bwd_reference(L, plain[0], adj, plain[1], plain[2],
                                           pgru, torch.as_tensor(dout))
    _close(_flat(got), _flat(want), "plain backward vs autograd")


def _tiny(seed, hidden=4, layers=2, p=1):
    """float64 inputs at a tiny width."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=0.5: (torch.randn(*s, generator=g, dtype=torch.float64)
                               * scale).requires_grad_()
    adj = (torch.rand(p, T, 4 * T, generator=g, dtype=torch.float64) < 0.02).double()
    gru = {k: r(*tfg.gru_shape(k, hidden)) for k in tfg.GRU_KEYS}
    return (layers, r(p, T, hidden), adj, r(layers, 4, hidden, hidden),
            r(layers, 4, hidden), gru)


def test_fused_ggnn_function_gradcheck():
    layers, h0, adj, msg_w, msg_b, gru = _tiny(3)
    fn = lambda h0, w, b, *g: tfg.fused_ggnn(
        layers, h0, adj, w, b, dict(zip(tfg.GRU_KEYS, g)))
    assert torch.autograd.gradcheck(
        fn, (h0, msg_w, msg_b, *(gru[k] for k in tfg.GRU_KEYS)))


def test_fused_ggnn_readout_function_gradcheck():
    layers, h0, adj, msg_w, msg_b, gru = _tiny(4)
    g = torch.Generator().manual_seed(5)
    mask = (torch.rand(1, T, generator=g) < 0.7).double()
    ro = [(torch.randn(*s, generator=g, dtype=torch.float64) * 0.5).requires_grad_()
          for s in ((8, 4), (4,), (4, 4), (4,))]
    fn = lambda h0, w, b, wi, bi, wj, bj, *gv: tfg.fused_ggnn_readout(
        layers, h0, adj, w, b, dict(zip(tfg.GRU_KEYS, gv)), mask, wi, bi, wj, bj)
    assert torch.autograd.gradcheck(
        fn, (h0, msg_w, msg_b, *ro, *(gru[k] for k in tfg.GRU_KEYS)))


def test_backward_wrappers_on_cpu_launch_nothing():
    args, readout, dout = _inputs(16, False, p=1)
    targs = [_conv(a, torch.as_tensor) for a in args]
    tfg.fused_ggnn_bwd.launches = 0
    tfg.fused_ggnn_readout_bwd.launches = 0
    dh0, dw, db, dgru = tfg.fused_ggnn_bwd(L, *targs, torch.as_tensor(dout))
    res = tfg.fused_ggnn_readout_bwd(L, *targs, *map(torch.as_tensor, readout),
                                     torch.as_tensor(dout))
    assert dh0.shape == (1, T, 16) and dw.shape == (L, 4, 16, 16)
    assert set(dgru) == set(tfg.GRU_KEYS) and len(res) == 8
    assert tfg.fused_ggnn_bwd.launches == 0
    assert tfg.fused_ggnn_readout_bwd.launches == 0


@pytest.mark.parametrize("readout", [False, True])
def test_backward_wrappers_raise_on_other_devices(readout):
    args, ro, dout = _inputs(16, False, p=1)
    meta = [_conv(a, lambda x: torch.as_tensor(x).to("meta")) for a in args]
    d = torch.as_tensor(dout).to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        if readout:
            tfg.fused_ggnn_readout_bwd(
                L, *meta, *(torch.as_tensor(a).to("meta") for a in ro), d)
        else:
            tfg.fused_ggnn_bwd(L, *meta, d)
    assert tfg.fused_ggnn_bwd.launches == 0


def test_grad_layout_matches_kernel_order():
    """The summed gradient row splits into the shapes of the weights, in
    the order the CUDA kernel writes them (GradLayout)."""
    shapes = tfg._grad_shapes(8, 32, 32)
    sizes = [int(np.prod(s)) for s in shapes]
    assert sum(sizes) == 8 * 4 * 32 * 33 + 9 * 32 * 32 + 3 * 32 + 3 * 32 * 32 + 2 * 32
    grads = torch.arange(sum(sizes), dtype=torch.float32)
    dw, db, dgru, (dwi, dbi, dwj, dbj) = tfg._split_grads(grads, shapes, sizes)
    assert dw.shape == (8, 4, 32, 32) and db.shape == (8, 4, 32)
    assert dgru["wz"].shape == (64, 32) and dgru["bn"].shape == (32,)
    # the GRU block starts after the message weights and biases
    assert float(dgru["wz"].flatten()[0]) == 8 * 4 * 32 * 33
    assert float(dbj[-1]) == sum(sizes) - 1
