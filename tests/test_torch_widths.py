"""Kernel widths: refused before any work on CUDA, and D != H in the JAX
default form.

- ``kernel_problems`` names a hidden width the card's kernels are not
  built for when the device is CUDA, and nothing on the CPU (it reads only
  the config, so it runs here without a card);
- the train and predict CLIs refuse such a width on ``--device cuda``
  before they open any CSV: the check comes before the CLIs ask whether
  CUDA is available, so nothing is patched;
- a GGNN whose readout width D differs from its hidden width H runs K1
  with the plain readout under the default flags, and its logits and
  gradients match the JAX packed predictor's default form."""

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
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.cli import train as train_cli
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, named_to_tree
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig

torch.set_num_threads(1)

SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dataset", "sample", "sample200.csv")

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5    # the JAX suite's forward bound (test_fused_ggnn.py:139)
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5  # its gradient bound (test_fused_ggnn.py:87)
ITEM = 'ROADMAP queue 2, "Open: hidden widths"'


@pytest.fixture
def flags():
    """Set the port's and the JAX package's form flags for one test."""
    saved = (tfg.TWOPASS, tpacked.FUSED_READOUT, jfg.TWOPASS,
             jpacked.FUSED_READOUT)

    def set_flags(twopass, port_readout, jax_readout):
        tfg.TWOPASS = jfg.TWOPASS = twopass
        tpacked.FUSED_READOUT = port_readout
        jpacked.FUSED_READOUT = jax_readout

    yield set_flags
    (tfg.TWOPASS, tpacked.FUSED_READOUT, jfg.TWOPASS,
     jpacked.FUSED_READOUT) = saved


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the width check


@pytest.mark.parametrize("method,path", [("ggnn", "fused"), ("mpnn", "coo")])
@pytest.mark.parametrize("as_dict", [False, True])
def test_kernel_problems_name_unbuilt_widths_on_cuda_only(method, path, as_dict):
    cfg = TrainConfig(method=method, compute_path=path, fp_hidden_dim=64,
                      fp_out_dim=64)
    assert loop.config_problems(cfg) == []
    arg = json.loads(cfg.to_json()) if as_dict else cfg
    problems = loop.kernel_problems(arg, "cuda")
    assert len(problems) == 1
    assert "fp_hidden_dim=64" in problems[0] and ITEM in problems[0]
    assert loop.kernel_problems(arg, torch.device("cuda", 0)) == problems
    assert loop.kernel_problems(arg, "cpu") == []
    for hidden in (16, 32):
        ok = dict(json.loads(cfg.to_json()), fp_hidden_dim=hidden)
        assert loop.kernel_problems(ok, "cuda") == []


def test_kernel_problems_take_d_other_than_h():
    # D != H runs K1 and the plain readout: only H is checked
    cfg = TrainConfig(compute_path="fused", fp_hidden_dim=32, fp_out_dim=16)
    assert loop.kernel_problems(cfg, "cuda") == []


def test_trainer_refuses_an_unbuilt_width_on_cuda_before_any_work():
    cfg = TrainConfig(compute_path="fused", fp_hidden_dim=64, fp_out_dim=64)
    ds = CSVPairParser().parse(pd.read_csv(SAMPLE).head(4)).dataset
    with pytest.raises(ValueError, match="fp_hidden_dim=64"):
        loop.Trainer(cfg, ds, device="cuda")
    # the plain versions take any width
    assert loop.Trainer(cfg, ds, device="cpu").model.encoder.hidden_dim == 64


@pytest.mark.parametrize("flags_", [["--fp-hidden-dim", "64"],
                                    ["--method", "mpnn", "--compute-path", "coo",
                                     "--fp-hidden-dim", "8"]])
def test_train_cli_refuses_an_unbuilt_width_before_reading_csvs(tmp_path, flags_):
    argv = ["--train", str(tmp_path / "missing.csv"),
            "--val", str(tmp_path / "missing_val.csv"), "--compute-path",
            "fused", "--device", "cuda", "--out", str(tmp_path / "run"), *flags_]
    with pytest.raises(ValueError, match="fp_hidden_dim") as e:
        train_cli.main(argv)
    assert ITEM in str(e.value)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("method", ["ggnn", "mpnn"])
def test_predict_cli_refuses_an_unbuilt_width_before_reading_pairs(tmp_path,
                                                                   method):
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"method": method, "sim_method": "hole",
                                  "fp_hidden_dim": 64, "fp_out_dim": 64,
                                  "conv_layers": 2}))
    argv = ["--input", str(tmp_path / "missing.csv"), "--config", str(config),
            "--params", str(tmp_path / "missing.npz"), "--device", "cuda",
            "--out", str(tmp_path / "preds.csv")]
    with pytest.raises(ValueError, match="fp_hidden_dim=64") as e:
        predict.main(argv)
    assert ITEM in str(e.value)
    assert not (tmp_path / "preds.csv").exists()


# ---------------------------------------------------------------------------
# D != H in the JAX default form


def test_fused_form_takes_the_widths(flags):
    flags(False, True, False)
    assert tpacked.fused_form(32, 32).startswith("K2/K2b")
    assert tpacked.fused_form(32, 16).startswith("K1/K1b")
    assert tpacked.readout_in_kernel(16, 16)
    assert not tpacked.readout_in_kernel(16, 32)
    flags(True, True, False)
    assert tpacked.fused_form(32, 16).startswith("K1m/K3")
    flags(False, False, False)
    assert tpacked.fused_form(16, 16).startswith("K1/K1b")


@pytest.mark.parametrize("twopass", [False, True])
@pytest.mark.parametrize("layers,hidden,out_dim,tied",
                         [(3, 32, 16, False), (2, 16, 32, True)])
def test_d_other_than_h_matches_jax_default_form(twopass, layers, hidden,
                                                 out_dim, tied, flags):
    """The port's default flags (``FUSED_READOUT`` on) with D != H: K1 (or
    K1m/K3) and the plain readout, no K2; logits and every parameter
    gradient against jax.grad of the JAX package's default form."""
    flags(twopass, True, False)
    assert tpacked.fused_form(hidden, out_dim).startswith(
        "K1m/K3" if twopass else "K1/K1b")
    cfg = dict(fp_hidden_dim=hidden, fp_out_dim=out_dim, conv_layers=layers,
               weight_tying=tied)
    ds = CSVPairParser().parse(pd.read_csv(SAMPLE).head(12)).dataset
    batch = pack_pair_dataset_coo(ds, list(range(12)))
    wire = compact_coo_arrays(batch)
    labels = np.asarray(batch.labels, np.float32)
    tree = init_params(cfg, seed=layers + hidden + out_dim)
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
