"""``fused_pair_logits`` and the GGNN kernel wrappers on the dense packed
adjacency, against the JAX package on the CPU:

- the port's ``fused_pair_logits`` in the K2 and the K1 forms (the
  wrappers' plain versions here) against the JAX one, whose Pallas
  kernels run in interpret mode as tests/test_fused_ggnn.py runs them,
  with an f32 and a bf16 adjacency: logits within atol = rtol = 1e-5, in
  f32 every gradient within 1e-4 max|want| + 1e-6;
- the kernel wrappers (K1, K1m, K2, and the backward of K1 and K2 in the
  K1b and K3 forms) on the dense (P, 4, T, T) adjacency, f32 and bf16,
  against the flat (P, T, 4T) one: equal bit for bit, outputs and
  gradients.

The dense predictors: tests/test_torch_dense_predictor.py, whose helpers
this file shares."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.data import packing as tpacking
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops import fused_ggnn as fg
from test_torch_dense_predictor import (
    ATOL, RTOL, _assert_grads_close, _dataset, _form, _jax_loss_and_grads,
    _port_loss)

torch.set_num_threads(1)


@pytest.mark.parametrize("adj_dtype", ["float32", "bfloat16"])
def test_fused_pair_logits_matches_jax(adj_dtype):
    """JAX's ``fused_pair_logits`` (its Pallas kernels in interpret mode,
    in its default K1 form) against the port's in the K2 and the K1
    forms: logits, and in f32 every gradient."""
    cfg = dict(method="ggnn", fp_hidden_dim=16, fp_out_dim=16, conv_layers=2,
               weight_tying=False, sim_method="hole")
    batch = tpacking.pack_pair_dataset_batch(_dataset(6), list(range(6)))
    args = list(tpacked.dense_batch_args(batch))
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=4)
    jpred = jpacked.make_packed_predictor(**cfg)
    jargs = [jnp.asarray(a) for a in args]
    jargs[1] = jargs[1].astype(getattr(jnp, adj_dtype))
    f32 = adj_dtype == "float32"
    with pltpu.force_tpu_interpret_mode():
        if f32:
            _, want_logits, want = _jax_loss_and_grads(
                jpred, tree, jargs, labels,
                apply=lambda p, *a: jpacked.fused_pair_logits(jpred, p, *a))
        else:
            want_logits = np.asarray(
                jpacked.fused_pair_logits(jpred, tree, *jargs))
    targs = [torch.as_tensor(a) for a in args]
    targs[1] = targs[1].to(getattr(torch, adj_dtype))
    for fused_readout in (True, False):
        model = from_jax_params(
            tree, tpacked.make_packed_predictor(**cfg, compact=False))
        with _form(fused_readout, False):
            _, logits = _port_loss(model, targs, labels,
                                   fn=lambda *a: tpacked.fused_pair_logits(
                                       model, *a))
            assert np.array_equal(logits, model(*targs).detach().numpy())
        np.testing.assert_allclose(logits, want_logits, rtol=RTOL, atol=ATOL)
        if f32:
            _assert_grads_close(model, want)
    relgcn = tpacked.make_packed_predictor(method="relgcn", compact=False)
    with pytest.raises(ValueError, match="PackedGGNN"):
        tpacked.fused_pair_logits(relgcn, *targs)


def _wrapper_inputs(p=2, hidden=16, n_layers=3, seed=0):
    rng = np.random.default_rng(seed)
    t = fg.TILE
    adj = (rng.random((p, fg.NUM_EDGE_TYPE, t, t)) < 0.02).astype(np.float32)
    h0 = rng.normal(0, 0.5, (p, t, hidden)).astype(np.float32)
    mask = (rng.random((p, t)) < 0.8).astype(np.float32)
    w = lambda *s: torch.as_tensor(rng.normal(0, 0.3, s).astype(np.float32))
    gru = {k: w(*fg.gru_shape(k, hidden)) for k in fg.GRU_KEYS}
    readout = (w(2 * hidden, hidden), w(hidden), w(hidden, hidden), w(hidden))
    return (torch.as_tensor(h0), torch.as_tensor(adj), w(n_layers, 4, hidden,
            hidden), w(n_layers, 4, hidden), gru, torch.as_tensor(mask),
            readout)


@pytest.mark.parametrize("twopass", [False, True], ids=["k1b", "k3"])
def test_kernel_wrappers_take_the_dense_adjacency(twopass):
    h0, adj, msg_w, msg_b, gru, mask, readout = _wrapper_inputs()
    p, e, t, _ = adj.shape
    flat = adj.permute(0, 2, 1, 3).reshape(p, t, e * t).contiguous()
    assert torch.equal(fg.flat_adjacency(adj), flat)
    assert fg.flat_adjacency(flat) is flat
    n_layers = msg_w.shape[0]

    def run(a):
        leaves = [h0, msg_w, msg_b, *gru.values(), *readout]
        leaves = [x.clone().requires_grad_(True) for x in leaves]
        x0, mw, mb = leaves[:3]
        g = dict(zip(gru, leaves[3:3 + len(gru)]))
        ro = leaves[3 + len(gru):]
        with _form(True, twopass):
            h = fg.fused_ggnn(n_layers, x0, a, mw, mb, g)
            nodes = fg.fused_ggnn_readout(n_layers, x0, a, mw, mb, g, mask,
                                          *ro)
            mid = fg.fused_ggnn_mid(n_layers, x0.detach(), a, mw.detach(),
                                    mb.detach(),
                                    {k: v.detach() for k, v in g.items()})
        (h.square().sum() + nodes.sum()).backward()
        return [h.detach(), nodes.detach(), *mid] + [x.grad for x in leaves]

    want = run(flat)
    for a in (adj, adj.to(torch.bfloat16), flat.to(torch.bfloat16)):
        got = run(a)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
