"""The split GGNN backward and the JAX-default fused form on the CPU.

- K1m's and K3's plain versions against the JAX package's
  ``_fused_ggnn_fwd`` (TWOPASS branch) and ``_half_bwd_call`` (Pallas in
  interpret mode, as tests/test_fused_ggnn.py runs them);
- the port's two-pass VJP against its single-pass one;
- the whole predictor in the JAX-default form (``FUSED_READOUT`` off),
  with and without TWOPASS, against ``jax.grad`` of
  ``fused_compact_logits`` under the same JAX flags;
- scan mode: ``scan_chunk_iterator`` against the JAX one, the trainer's
  chunks against its per-step run, the step count and the dropped tail;
- the production preset through the train CLI.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.ops import fused_ggnn as jfg
from gcnbmp_tpu.train import loop as jloop
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, named_to_tree
from gcnbmp_tpu_torch.data import CSVPairParser, estimate_coo_capacities
from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu_torch.data.wire import (
    compact_coo_arrays, packed_coo_batch_iterator, scan_chunk_iterator)
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import PRESETS, TrainConfig

torch.set_num_threads(1)

T = 128
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5    # the JAX suite's forward bound (test_fused_ggnn.py:139)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5  # its gradient bound (test_fused_ggnn.py:87)
SPLIT_RTOL, SPLIT_ATOL = 1e-5, 1e-7  # two-pass vs single-pass (test_fused_ggnn.py:330-332)
SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dataset", "sample", "sample200.csv")


def _inputs(layers, hidden, tied, p=2, seed=0):
    """K1 inputs and an upstream gradient, in numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    h0 = f32(p, T, hidden)
    adj = (rng.random((p, T, 4 * T)) < 0.01).astype(np.float32)
    n_msg = 1 if tied else layers
    msg_w = f32(n_msg, 4, hidden, hidden, scale=hidden ** -0.5)
    msg_b = f32(n_msg, 4, hidden, scale=0.1)
    if tied:
        msg_w, msg_b = np.repeat(msg_w, layers, 0), np.repeat(msg_b, layers, 0)
    gru = {k: f32(*tfg.gru_shape(k, hidden),
                  scale=0.1 if k[0] == "b" else tfg.gru_shape(k, hidden)[0] ** -0.5)
           for k in tfg.GRU_KEYS}
    return [h0, adj, msg_w, msg_b, gru], f32(p, T, hidden)


def _conv(x, fn):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _flat(grads):
    out = []
    for g in grads:
        if isinstance(g, dict):
            out += [g[k] for k in tfg.GRU_KEYS]
        else:
            out.append(g)
    return [np.asarray(g.detach().numpy() if isinstance(g, torch.Tensor) else g)
            for g in out]


@pytest.fixture
def flags():
    """Set the port's and the JAX package's form flags for one test."""
    saved = (tfg.TWOPASS, tpacked.FUSED_READOUT, jfg.TWOPASS,
             jpacked.FUSED_READOUT)

    def set_flags(twopass, fused_readout):
        tfg.TWOPASS = jfg.TWOPASS = twopass
        tpacked.FUSED_READOUT = jpacked.FUSED_READOUT = fused_readout

    yield set_flags
    (tfg.TWOPASS, tpacked.FUSED_READOUT, jfg.TWOPASS,
     jpacked.FUSED_READOUT) = saved


# ---------------------------------------------------------------------------
# K1m and K3: plain versions against the Pallas kernels


@pytest.mark.parametrize("layers", [2, 3, 4])
@pytest.mark.parametrize("hidden", [16, 32])
def test_k1m_plain_matches_jax_mid_forward(layers, hidden, flags):
    args, _ = _inputs(layers, hidden, tied=False, seed=layers)
    flags(True, False)
    with pltpu.force_tpu_interpret_mode():
        want_h, res = jfg._fused_ggnn_fwd(layers, *(_conv(a, jnp.asarray) for a in args))
    want_mid = res[-1]
    got_h, got_mid = tfg.fused_ggnn_mid(layers, *(_conv(a, torch.as_tensor) for a in args))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(want_mid),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    # K1m's h is K1's, and h_mid is the input of layer L // 2
    targs = [_conv(a, torch.as_tensor) for a in args]
    torch.testing.assert_close(got_h, tfg.fused_ggnn_reference(layers, *targs),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        got_mid, tfg.fused_ggnn_reference(layers // 2, targs[0], targs[1],
                                          targs[2][:layers // 2],
                                          targs[3][:layers // 2], targs[4]),
        rtol=0, atol=0)


def _half_ranges():
    for layers in (2, 3, 4):
        split = layers // 2
        for lo, hi in ((0, split), (split, layers)):
            yield layers, lo, hi


@pytest.mark.parametrize("layers,lo,hi", list(_half_ranges()))
def test_k3_plain_matches_jax_half_bwd(layers, lo, hi):
    hidden = 16
    (hin, adj, msg_w, msg_b, gru), dh_top = _inputs(layers, hidden, tied=False,
                                                    seed=10 * layers + lo)
    p = hin.shape[0]
    k = min(jfg.DEFAULT_BWD_BLOCK_TILES, p)
    jgru = _conv(gru, jnp.asarray)
    jw, jb = jnp.asarray(msg_w), jnp.asarray(msg_b)
    with pltpu.force_tpu_interpret_mode():
        want = jfg._half_bwd_call(
            lo, hi, layers, k, p, T, hidden, jfg._weight_args(jw, jb, jgru),
            jw, jb, jnp.asarray(hin), jfg._prep_adj(jnp.asarray(adj), k),
            jnp.asarray(dh_top))
    assert len(want) == 12
    got = tfg.fused_ggnn_half_bwd(
        lo, hi, torch.as_tensor(hin), torch.as_tensor(adj), torch.as_tensor(msg_w),
        torch.as_tensor(msg_b), _conv(gru, torch.as_tensor), torch.as_tensor(dh_top))
    got = _flat(got)
    assert len(got) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b).reshape(a.shape)  # the JAX biases are (.., 1, H)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"L={layers} [{lo}, {hi}) output {i}")
    # gradients of the message weights outside the range are zero
    outside = [l for l in range(layers) if not lo <= l < hi]
    assert not got[1][outside].any() and not got[2][outside].any()


# ---------------------------------------------------------------------------
# the two-pass VJP against the single-pass one


@pytest.mark.parametrize("layers", [2, 3, 4])
@pytest.mark.parametrize("tied", [True, False])
def test_twopass_vjp_matches_single_pass(layers, tied, flags):
    args, dh = _inputs(layers, 32, tied, seed=layers + 7 * tied)
    # an upstream gradient of the size a mean loss over a batch gives, as
    # in the JAX test: the two orders of the GRU sums then differ by less
    # than atol
    dh = dh * 1e-2
    h0, adj, msg_w, msg_b, gru = [_conv(a, torch.as_tensor) for a in args]
    leaves = [h0, msg_w, msg_b, *(gru[k] for k in tfg.GRU_KEYS)]

    def grads(twopass):
        flags(twopass, True)
        xs = [x.clone().requires_grad_() for x in leaves]
        before = tfg.FusedGGNNFunction.backward_calls
        h = tfg.fused_ggnn(layers, xs[0], adj, xs[1], xs[2],
                           dict(zip(tfg.GRU_KEYS, xs[3:])))
        out = torch.autograd.grad(h, xs, torch.as_tensor(dh))
        assert tfg.FusedGGNNFunction.backward_calls == before + 1
        return h.detach(), out

    h1, one = grads(False)
    h2, two = grads(True)
    torch.testing.assert_close(h2, h1, rtol=0, atol=0)
    for i, (a, b) in enumerate(zip(two, one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SPLIT_RTOL,
                                   atol=SPLIT_ATOL, err_msg=f"L={layers} #{i}")


def test_twopass_function_gradcheck(flags):
    flags(True, True)
    g = torch.Generator().manual_seed(3)
    layers, hidden = 3, 4
    rnd = lambda *s, scale=0.5: (torch.randn(*s, generator=g, dtype=torch.float64)
                                 * scale).requires_grad_()
    h0 = rnd(1, T, hidden)
    adj = (torch.rand(1, T, 4 * T, generator=g) < 0.02).double()
    msg_w, msg_b = rnd(layers, 4, hidden, hidden), rnd(layers, 4, hidden)
    gru = [rnd(*tfg.gru_shape(k, hidden)) for k in tfg.GRU_KEYS]
    before = tfg.FusedGGNNFunction.backward_calls
    fn = lambda h0, w, b, *gv: tfg.fused_ggnn(
        layers, h0, adj, w, b, dict(zip(tfg.GRU_KEYS, gv)))
    assert torch.autograd.gradcheck(fn, (h0, msg_w, msg_b, *gru))
    assert tfg.FusedGGNNFunction.backward_calls > before


def test_twopass_wrappers_on_cpu_launch_nothing_and_raise_elsewhere(flags):
    args, dh = _inputs(4, 16, tied=False, p=1)
    targs = [_conv(a, torch.as_tensor) for a in args]
    tfg.fused_ggnn_mid.launches = tfg.fused_ggnn_half_bwd.launches = 0
    h, mid = tfg.fused_ggnn_mid(4, *targs)
    res = tfg.fused_ggnn_half_bwd(2, 4, mid, *targs[1:], torch.as_tensor(dh))
    assert h.shape == mid.shape == (1, T, 16) and res[1].shape == (4, 4, 16, 16)
    assert tfg.fused_ggnn_mid.launches == tfg.fused_ggnn_half_bwd.launches == 0
    meta = [_conv(a, lambda x: x.to("meta")) for a in targs]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tfg.fused_ggnn_mid(4, *meta)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tfg.fused_ggnn_half_bwd(0, 2, *meta, torch.as_tensor(dh).to("meta"))
    assert tfg.fused_ggnn_mid.launches == tfg.fused_ggnn_half_bwd.launches == 0


def test_twopass_is_ignored_at_one_layer_and_without_gradients(flags):
    args, dh = _inputs(1, 16, tied=False, p=1)
    h0, adj, msg_w, msg_b, gru = [_conv(a, torch.as_tensor) for a in args]
    flags(True, True)
    calls = {"mid": 0}
    real = tfg.fused_ggnn_mid

    def counting(*a):
        calls["mid"] += 1
        return real(*a)

    tfg.fused_ggnn_mid = counting
    try:
        w = msg_w.clone().requires_grad_()
        tfg.fused_ggnn(1, h0, adj, w, msg_b, gru).sum().backward()
        assert w.grad is not None and calls["mid"] == 0
        args4, _ = _inputs(4, 16, tied=False, p=1)
        t4 = [_conv(a, torch.as_tensor) for a in args4]
        with torch.no_grad():
            tfg.fused_ggnn(4, *t4)
        assert calls["mid"] == 0
        w4 = t4[2].clone().requires_grad_()
        tfg.fused_ggnn(4, t4[0], t4[1], w4, t4[3], t4[4]).sum().backward()
        assert calls["mid"] == 1
    finally:
        tfg.fused_ggnn_mid = real


# ---------------------------------------------------------------------------
# the whole predictor in the JAX-default form


def _sample(n):
    return CSVPairParser().parse(pd.read_csv(SAMPLE).head(n)).dataset


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("twopass", [False, True])
@pytest.mark.parametrize("layers,hidden,tied", [(3, 16, False), (4, 32, True)])
def test_jax_default_form_matches_jax(twopass, layers, hidden, tied, flags):
    """FUSED_READOUT off: K1 (or K1m/K3) and the plain readout; logits and
    every parameter gradient against jax.grad of fused_compact_logits
    under the same flags, at the JAX suite's gradient bound."""
    flags(twopass, False)
    cfg = dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=layers,
               weight_tying=tied)
    batch = pack_pair_dataset_coo(_sample(12), list(range(12)))
    wire = compact_coo_arrays(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=layers + hidden)
    pred = jpacked.make_packed_predictor(**cfg, coo=True, compact=True)

    def jlogits(params):
        return jpacked.fused_compact_logits(pred, params,
                                            *(jnp.asarray(a) for a in wire))

    def jloss(params):
        return jloop.sigmoid_cross_entropy(jlogits(params), jnp.asarray(labels))

    with pltpu.force_tpu_interpret_mode():
        want_logits = jlogits(tree)
        want = jax.grad(jloss)(tree)
    model = from_jax_params(tree, tpacked.make_packed_predictor(**cfg))
    readout_calls = tfg.FusedGGNNReadoutFunction.backward_calls
    calls = tfg.FusedGGNNFunction.backward_calls
    logits = model(*(torch.as_tensor(np.asarray(a)) for a in wire))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    loop.sigmoid_cross_entropy(logits, torch.as_tensor(labels)).backward()
    assert tfg.FusedGGNNFunction.backward_calls == calls + 1
    assert tfg.FusedGGNNReadoutFunction.backward_calls == readout_calls
    got = _flat_tree(named_to_tree({n: p.grad for n, p in model.named_parameters()}))
    want = _flat_tree(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def test_fused_form_names_the_kernels(flags):
    flags(False, True)
    assert tpacked.fused_form().startswith("K2/K2b")
    flags(True, True)  # TWOPASS changes nothing on the K2 form
    assert tpacked.fused_form().startswith("K2/K2b")
    flags(False, False)
    assert tpacked.fused_form().startswith("K1/K1b")
    flags(True, False)
    assert tpacked.fused_form().startswith("K1m/K3")


# ---------------------------------------------------------------------------
# scan mode


def test_scan_chunk_iterator_matches_the_jax_one():
    ds = _sample(48)
    tiles, cap = estimate_coo_capacities([ds], 8)
    batches = list(packed_coo_batch_iterator(ds, 8, tiles, cap,
                                             np.random.default_rng(1)))
    assert len(batches) == 6
    got = list(scan_chunk_iterator(iter(batches), 4, compact_coo_arrays))
    want = list(jloop.scan_chunk_iterator(iter(batches), 4,
                                          jpacked.compact_coo_arrays))
    assert len(got) == len(want) == 1  # the tail chunk of 2 is dropped
    (g_args, g_labels, g_edges), (w_args, w_labels, w_edges) = got[0], want[0]
    assert len(g_args) == len(w_args) == 5
    for a, b in zip(g_args, w_args):
        assert a.shape[0] == 4 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g_labels, w_labels)
    assert g_edges == w_edges == sum(b.num_edges for b in batches[:4])


def test_stage_chunk_round_trips_one_buffer():
    ds = _sample(16)
    tiles, cap = estimate_coo_capacities([ds], 8)
    batches = packed_coo_batch_iterator(ds, 8, tiles, cap, np.random.default_rng(0))
    stacked, labels, _ = next(scan_chunk_iterator(batches, 2, compact_coo_arrays))
    args, lab = loop.stage_chunk(stacked, labels, torch.device("cpu"))
    base = args[0].untyped_storage().data_ptr()
    for t, a in zip(args, stacked):
        assert t.untyped_storage().data_ptr() == base  # one buffer
        np.testing.assert_array_equal(t.numpy(), a)
    assert lab.dtype == torch.float32
    np.testing.assert_array_equal(lab.numpy(), labels)
    with pytest.raises(TypeError, match="4-byte"):
        loop.stage_chunk((np.zeros(3, np.int64),), labels, torch.device("cpu"))


def _fit(tmp_path, ds, scan_steps, epochs, **kw):
    cfg = TrainConfig(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2,
                      compute_path="fused", batch_size=8, learning_rate=5e-3,
                      scan_steps=scan_steps, epochs=epochs, eval_train=False,
                      out_dir=str(tmp_path / f"run{scan_steps}"), **kw)
    losses = []
    real = loop.train_step

    def recording(*a, **k):
        out = real(*a, **k)
        losses.append(float(out))
        return out

    loop.train_step = recording
    try:
        trainer = loop.Trainer(cfg, ds, device="cpu")
        result = trainer.fit()
    finally:
        loop.train_step = real
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return losses, params, result["state"]


@pytest.mark.parametrize("reuse_packs", [False, True])
def test_scan_trainer_matches_per_step_training(tmp_path, reuse_packs):
    ds = _sample(48)  # 6 steps per epoch: 2 chunks of 3
    l0, p0, s0 = _fit(tmp_path, ds, 0, 2, reuse_packs=reuse_packs)
    l3, p3, s3 = _fit(tmp_path, ds, 3, 2, reuse_packs=reuse_packs)
    assert len(l0) == len(l3) == 12 and s0.step == s3.step == 12
    assert l3 == l0
    for name in p0:
        torch.testing.assert_close(p3[name], p0[name], rtol=0, atol=0)


def test_scan_steps_advance_by_chunks_and_drop_the_tail(tmp_path):
    ds = _sample(40)  # 5 steps per epoch: 2 chunks of 2, the tail batch dropped
    losses, _, state = _fit(tmp_path, ds, 2, 2)
    assert len(losses) == 8 and state.step == 8 and state.epoch == 2
    with pytest.raises(ValueError, match="exceeds the 5 batches per epoch"):
        loop.Trainer(TrainConfig(compute_path="fused", batch_size=8,
                                 scan_steps=6), ds, device="cpu")


# ---------------------------------------------------------------------------
# the production preset


def test_production_preset_passes_config_problems():
    prod = PRESETS["ggnn_hole_production"]
    assert (prod.compute_path, prod.compute_dtype, prod.scan_steps) == (
        "coo", "bfloat16", 10)
    assert loop.config_problems(prod) == []
    import dataclasses
    assert loop.config_problems(dataclasses.replace(prod, compute_path="fused")) == []


@pytest.mark.parametrize("path,twopass,fused_readout",
                         [("coo", False, True), ("fused", True, False)])
def test_production_preset_trains_one_cpu_epoch(tmp_path, capsys, flags, path,
                                                twopass, fused_readout):
    """The preset as it stands (coo, bf16 computed in f32, scan 10, reused
    packs), and on the fused path in the two-pass JAX-default form, at
    batch 8: 40 pairs, 80 with augmentation, one chunk of 10 steps."""
    flags(twopass, fused_readout)
    pd.read_csv(SAMPLE).head(40).to_csv(tmp_path / "train.csv", index=False)
    pd.read_csv(SAMPLE).iloc[40:56].to_csv(tmp_path / "val.csv", index=False)
    fn = (tfg.FusedGGNNReadoutFunction if fused_readout
          else tfg.FusedGGNNFunction)
    calls = fn.backward_calls
    out = tmp_path / "run"
    rc = train_cli.main(["--train", str(tmp_path / "train.csv"), "--val",
                         str(tmp_path / "val.csv"), "--preset",
                         "ggnn_hole_production", "--compute-path", path,
                         "--batch-size", "8", "--epochs", "1", "--device", "cpu",
                         "--out", str(out)])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["main/loss"]) and np.isfinite(final["val/loss"])
    assert fn.backward_calls == calls + 10
    cfg = json.loads((out / "config.json").read_text())
    assert (cfg["scan_steps"], cfg["compute_dtype"], cfg["conv_layers"]) == (
        10, "bfloat16", 8)
    with np.load(out / "final" / "opt_state.npz") as z:
        assert int(z["step"]) == int(z["count"]) == 10
