"""The fused GGNN forward kernels' plain versions against the JAX Pallas
kernels (interpret mode on the CPU, as tests/test_fused_ggnn.py runs
them), and the wrappers' CPU behaviour.  The CUDA kernels themselves are
checked against these plain versions on the card by chip_smoke.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.ops import fused_ggnn as jfg
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.models.packed import make_packed_predictor
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # the JAX suite's own bound (test_fused_ggnn.py:139)
L = 3
T = 128


def _inputs(hidden, tied, p=3, d=None, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    h0 = f32(p, T, hidden)
    adj = (rng.random((p, T, 4 * T)) < 0.01).astype(np.float32)
    n_msg = 1 if tied else L
    msg_w = f32(n_msg, 4, hidden, hidden, scale=hidden ** -0.5)
    msg_b = f32(n_msg, 4, hidden, scale=0.1)
    if tied:
        msg_w, msg_b = np.repeat(msg_w, L, 0), np.repeat(msg_b, L, 0)
    gru = {}
    for k in tfg.GRU_KEYS:
        shape = ((hidden,) if k.startswith("b") else
                 (2 * hidden, hidden) if k.startswith("w") else (hidden, hidden))
        gru[k] = f32(*shape, scale=0.1 if k.startswith("b") else shape[0] ** -0.5)
    d = d or hidden
    readout = (
        (rng.random((p, T)) < 0.8).astype(np.float32),
        f32(2 * hidden, d, scale=(2 * hidden) ** -0.5), f32(d, scale=0.1),
        f32(hidden, d, scale=hidden ** -0.5), f32(d, scale=0.1),
    )
    return (h0, adj, msg_w, msg_b, gru), readout


def _jax(x):
    return ({k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict)
            else jnp.asarray(x))


def _torch(x):
    return ({k: torch.as_tensor(v) for k, v in x.items()} if isinstance(x, dict)
            else torch.as_tensor(x))


CASES = [(16, True), (16, False), (32, True), (32, False)]


@pytest.mark.parametrize("hidden,tied", CASES)
def test_fused_ggnn_plain_matches_pallas(hidden, tied):
    args, _ = _inputs(hidden, tied)
    with pltpu.force_tpu_interpret_mode():
        want = jfg.fused_ggnn(L, *map(_jax, args))
    got = tfg.fused_ggnn(L, *map(_torch, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden,tied", CASES)
def test_fused_ggnn_readout_plain_matches_pallas(hidden, tied):
    args, readout = _inputs(hidden, tied, d=32 if hidden == 16 else 16, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jfg.fused_ggnn_readout(L, *map(_jax, args), *map(_jax, readout))
    got = tfg.fused_ggnn_readout(L, *map(_torch, args), *map(_torch, readout))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tied", [True, False])
def test_params_to_fused_matches_jax(tied):
    cfg = dict(fp_hidden_dim=16, fp_out_dim=16, conv_layers=L, weight_tying=tied)
    tree = init_params(cfg, seed=5)
    msg_w, msg_b, gru = tfg.params_to_fused(
        from_jax_params(tree, make_packed_predictor(**cfg)).encoder)
    jw, jb, jgru = jfg.params_to_fused(tree["encoder"], L, tied, 16)
    np.testing.assert_array_equal(msg_w.detach().numpy(), np.asarray(jw))
    np.testing.assert_array_equal(msg_b.detach().numpy(), np.asarray(jb))
    for k in tfg.GRU_KEYS:
        np.testing.assert_array_equal(gru[k].detach().numpy(), np.asarray(jgru[k]))


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    args, readout = _inputs(16, False, p=1)
    tfg.fused_ggnn.launches = 0
    tfg.fused_ggnn_readout.launches = 0
    targs = list(map(_torch, args))
    h = tfg.fused_ggnn(L, *targs)
    g = tfg.fused_ggnn_readout(L, *targs, *map(_torch, readout))
    assert h.shape == (1, T, 16) and g.shape == (1, T, 16)
    assert tfg.fused_ggnn.launches == 0 and tfg.fused_ggnn_readout.launches == 0


def test_non_cuda_device_raises_instead_of_falling_back():
    args, _ = _inputs(16, False, p=1)
    meta = [(({k: v.to("meta") for k, v in a.items()}) if isinstance(a, dict)
             else a.to("meta")) for a in map(_torch, args)]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        tfg.fused_ggnn(L, *meta)
    assert tfg.fused_ggnn.launches == 0


def test_kernel_module_imports_and_runs_on_cpu_without_nvcc(tmp_path):
    code = (
        "import shutil, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "from gcnbmp_tpu_torch.ops import build, fused_ggnn as f\n"
        "h = f.fused_ggnn(1, torch.zeros(1, 128, 16), torch.zeros(1, 128, 512),\n"
        "    torch.zeros(1, 4, 16, 16), torch.zeros(1, 4, 16),\n"
        "    {k: torch.zeros((16,) if k[0] == 'b' else (32 if k[0] == 'w' else 16, 16))\n"
        "     for k in f.GRU_KEYS})\n"
        "assert f.fused_ggnn.launches == 0 and build.last_build_log is None\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
