"""The checks of the GGNN kernels' CUDA sources run on the CPU (built by
``emulate.build_emulated``), shared by the test files that split their
cases so that pytest-xdist's ``--dist loadfile`` can spread the slow H=64
and H=128 ones over workers: ``tests/test_torch_fwd_emulated{,64,128,128_k2}.py``
(K1, K1m, K2) and
``tests/test_torch_bwd_emulated{,64,64_k3,64_k2b,128,128_k3,128_k2b}.py``
(K1b, K3, K2b).

Forward outputs are held against their plain PyTorch versions at
chip_smoke.py's bound (atol = rtol = 1e-4: f32 sums in another order);
K1m's h must equal K1's bit for bit and a second run must give the same
bits.  Gradients are held at chip_smoke.py's gradient bound, K3's halves
summed against K1b, and two K2b runs must give the same bits."""

import numpy as np
import torch

from gcnbmp_tpu_torch.ops import fused_ggnn as fg

T = fg.TILE
CAP = 16  # the kernels' NBR_CAP
ATOL = RTOL = 1e-4  # chip_smoke.py's bound for the forward kernels
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # chip_smoke.py's gradient bound


def ggnn_inputs(p, hidden, crowd, layers, seed, rng=None):
    """((layers, h0, adj, msg_w, msg_b, gru), readout) on CPU tensors: a
    random adjacency of ~0.8% density (crowd: ~5% of the columns of every
    other row, more than the kernels' neighbour slots), seeded weights;
    drawn from ``rng`` when given, else from ``seed``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    f32 = lambda *s, scale=1.0: torch.as_tensor(
        (rng.standard_normal(s) * scale).astype(np.float32))
    adj = (rng.random((p, T, 4 * T)) < 0.008).astype(np.float32)
    if crowd:  # ~5% of the columns of every other row
        extra = rng.random(adj.shape) < 0.05
        extra[:, 1::2] = False
        adj[extra] = 1.0
        assert ((adj != 0).sum(-1) > CAP).any()
    gru = {k: f32(*fg.gru_shape(k, hidden),
                  scale=0.1 if k[0] == "b" else fg.gru_shape(k, hidden)[0] ** -0.5)
           for k in fg.GRU_KEYS}
    mask = torch.as_tensor((rng.random((p, T)) < 0.8).astype(np.float32))
    readout = (mask, f32(2 * hidden, hidden, scale=0.2), f32(hidden, scale=0.1),
               f32(hidden, hidden, scale=0.2), f32(hidden, scale=0.1))
    args = (layers, f32(p, T, hidden), torch.as_tensor(adj),
            f32(layers, 4, hidden, hidden, scale=hidden ** -0.5),
            f32(layers, 4, hidden, scale=0.1), gru)
    return args, readout


def assert_close(got, want, what):
    assert got.shape == want.shape, what
    assert bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all()), what


def k1(lib, n_layers, h0, adj, msg_w, msg_b, gru, split=None):
    """K1, or K1m with ``split``, on CPU tensors as the wrapper calls it."""
    p, _, hidden = h0.shape
    out, mid = torch.empty_like(h0), torch.empty_like(h0)
    head = (h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru))
    if split is None:
        assert lib.fused_ggnn_fwd(*head, out.data_ptr(), p, n_layers, hidden, None) == 0
        return out
    assert lib.fused_ggnn_mid_fwd(*head, out.data_ptr(), mid.data_ptr(), p,
                                  n_layers, split, hidden, None) == 0
    return out, mid


def k2(lib, n_layers, h0, adj, msg_w, msg_b, gru, readout):
    p, _, hidden = h0.shape
    out = torch.empty_like(h0)
    assert lib.fused_ggnn_readout_fwd(
        h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
        *(x.data_ptr() for x in readout), out.data_ptr(), p, n_layers, hidden,
        hidden, None) == 0
    return out


def check_k1_k1m(lib, case, seed):
    """K1 and K1m against plain; K1m's h is K1's and K1 repeats, bit for bit.
    ``case``: (tiles, hidden, crowded rows, layers)."""
    args, _ = ggnn_inputs(*case, seed=seed)
    h = k1(lib, *args)
    assert_close(h, fg.fused_ggnn_reference(*args), "K1")
    h_m, mid = k1(lib, *args, split=args[0] // 2)
    want_h, want_mid = fg.fused_ggnn_mid_reference(*args)
    assert_close(h_m, want_h, "K1m h")
    assert_close(mid, want_mid, "K1m h_mid")
    assert torch.equal(h_m, h)
    assert torch.equal(k1(lib, *args), h)


def check_k2(lib, case, seed):
    """K2 against plain, and a second run with the same bits."""
    args, readout = ggnn_inputs(*case, seed=seed)
    got = k2(lib, *args, readout)
    assert_close(got, fg.fused_ggnn_readout_reference(*args, *readout), "K2")
    assert torch.equal(k2(lib, *args, readout), got)


# -- the reverse body ---------------------------------------------------------

def bwd_inputs(p, layers, hidden, crowd, seed):
    """(h0, adj, msg_w, msg_b, gru, readout, upstream gradient): the
    forward's inputs, then the gradient drawn after them."""
    rng = np.random.default_rng(seed)
    (_, h0, adj, msg_w, msg_b, gru), readout = ggnn_inputs(
        p, hidden, crowd, layers, seed, rng)
    dout = torch.as_tensor(rng.standard_normal((p, T, hidden)).astype(np.float32))
    return h0, adj, msg_w, msg_b, gru, readout, dout


def _flat(result):
    out = []
    for x in result:
        out += [x[k] for k in fg.GRU_KEYS] if isinstance(x, dict) else [x]
    return out


def assert_grads_close(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        bound = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
        assert float((g - w).abs().max()) <= bound, f"tensor {i}"


def range_bwd(lib, lo, hi, hin, adj, msg_w, msg_b, gru, dh_top):
    """fused_ggnn_range_bwd on CPU tensors, buffers and results as the
    wrapper's (``fused_ggnn_half_bwd``: full-size message gradients)."""
    p, _, hidden = hin.shape
    dh_bot, partial, grads, hs, acts, shapes, sizes = fg._bwd_buffers(
        p, hi - lo, hidden, None, "cpu")
    err = lib.fused_ggnn_range_bwd(
        hin.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
        dh_top.data_ptr(), dh_bot.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), hs.data_ptr(), fg._ptr(acts), p, lo, hi, hidden, None)
    assert err == 0
    dmsg_w, dmsg_b, dgru, _ = fg._split_grads(grads, shapes, sizes)
    full_w, full_b = torch.zeros_like(msg_w), torch.zeros_like(msg_b)
    full_w[lo:hi], full_b[lo:hi] = dmsg_w, dmsg_b
    return dh_bot, full_w, full_b, dgru


def readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg):
    p, _, hidden = h0.shape
    dh0, partial, grads, hs, acts, shapes, sizes = fg._bwd_buffers(
        p, layers, hidden, hidden, "cpu")
    err = lib.fused_ggnn_readout_bwd(
        h0.data_ptr(), adj.data_ptr(), *fg._weight_ptrs(msg_w, msg_b, gru),
        *(x.data_ptr() for x in readout), dg.data_ptr(), dh0.data_ptr(),
        partial.data_ptr(), grads.data_ptr(), hs.data_ptr(), fg._ptr(acts), p,
        layers, hidden, hidden, None)
    assert err == 0
    dmsg_w, dmsg_b, dgru, rest = fg._split_grads(grads, shapes, sizes)
    return (dh0, dmsg_w, dmsg_b, dgru, *rest)


def check_k1b(lib, case):
    """K1b against plain.  ``case``: (tiles, layers, hidden, crowded rows)."""
    p, layers, hidden, crowd = case
    h0, adj, msg_w, msg_b, gru, _, dout = bwd_inputs(p, layers, hidden, crowd, 1)
    assert_grads_close(
        range_bwd(lib, 0, layers, h0, adj, msg_w, msg_b, gru, dout),
        fg.fused_ggnn_bwd_reference(layers, h0, adj, msg_w, msg_b, gru, dout))


def check_k3(lib, case):
    """K3's halves against plain, and summed against K1b."""
    p, layers, hidden, crowd = case
    h0, adj, msg_w, msg_b, gru, _, dout = bwd_inputs(p, layers, hidden, crowd, 2)
    split = layers // 2
    h_mid = fg.fused_ggnn_mid_reference(layers, h0, adj, msg_w, msg_b, gru)[1]
    top = range_bwd(lib, split, layers, h_mid, adj, msg_w, msg_b, gru, dout)
    assert_grads_close(top, fg.fused_ggnn_half_bwd_reference(
        split, layers, h_mid, adj, msg_w, msg_b, gru, dout))
    bottom = range_bwd(lib, 0, split, h0, adj, msg_w, msg_b, gru, top[0])
    assert_grads_close(bottom, fg.fused_ggnn_half_bwd_reference(
        0, split, h0, adj, msg_w, msg_b, gru, top[0]))
    summed = (bottom[0], top[1] + bottom[1], top[2] + bottom[2],
              {k: top[3][k] + bottom[3][k] for k in fg.GRU_KEYS})
    assert_grads_close(summed, range_bwd(lib, 0, layers, h0, adj, msg_w,
                                         msg_b, gru, dout))


def check_k2b(lib, case):
    """K2b against plain, and a second run with the same bits."""
    p, layers, hidden, crowd = case
    h0, adj, msg_w, msg_b, gru, readout, dg = bwd_inputs(p, layers, hidden, crowd, 3)
    got = readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg)
    assert_grads_close(got, fg.fused_ggnn_readout_bwd_reference(
        layers, h0, adj, msg_w, msg_b, gru, *readout, dg))
    again = readout_bwd(lib, layers, h0, adj, msg_w, msg_b, gru, readout, dg)
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(again)))
