"""Kernel widths: refused before any work on CUDA, and D != H in the JAX
default form.

- ``kernel_problems`` names a hidden width the card's kernels are not
  built for when the device is CUDA (GGNN at 48, MPNN at 64), and nothing
  on the CPU (it reads only the config, so it runs here without a card);
  it takes GGNN at 64 on every kernel path, and GGNN at 128 from a caller
  that only serves (``serving``: the predict and evaluate CLIs) but not
  from a trainer, since H=128's reverse kernels are not built;
- the train and predict CLIs refuse such a width on ``--device cuda``
  before they open any CSV: the check comes before the CLIs ask whether
  CUDA is available, so nothing is patched;
- a GGNN whose readout width D differs from its hidden width H runs K1
  with the plain readout under the default flags, and its logits and
  gradients match the JAX packed predictor's default form."""

import dataclasses
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
# a width each method's kernels are not built for: GGNN's run 16, 32 and
# 64, MPNN's (K5, K4) 16 and 32
UNBUILT = {"ggnn": 48, "mpnn": 64}


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
    width = UNBUILT[method]
    cfg = TrainConfig(method=method, compute_path=path, fp_hidden_dim=width,
                      fp_out_dim=width)
    assert loop.config_problems(cfg) == []
    arg = json.loads(cfg.to_json()) if as_dict else cfg
    problems = loop.kernel_problems(arg, "cuda")
    assert len(problems) == 1
    assert f"fp_hidden_dim={width}" in problems[0] and ITEM in problems[0]
    assert loop.kernel_problems(arg, torch.device("cuda", 0)) == problems
    assert loop.kernel_problems(arg, "cpu") == []
    for hidden in (16, 32, 64) if method == "ggnn" else (16, 32):
        ok = dict(json.loads(cfg.to_json()), fp_hidden_dim=hidden)
        assert loop.kernel_problems(ok, "cuda") == []


@pytest.mark.parametrize("path", ["coo", "fused", "packed"])
def test_kernel_problems_take_ggnn_at_64_on_each_kernel_path(path):
    """GGNN at H=64 runs the forward and reverse bodies of that width
    (fused_ggnn64.cuh) on every path that launches them; MPNN at 64 is
    still refused (K5, K5b, K4, K4b are built for 16 and 32)."""
    cfg = TrainConfig(compute_path=path, fp_hidden_dim=64, fp_out_dim=64)
    assert loop.config_problems(cfg) == []
    assert loop.kernel_problems(cfg, "cuda") == []
    assert loop.kernel_problems(dataclasses.replace(cfg, fp_out_dim=32), "cuda") == []
    if path != "fused":
        mpnn = dataclasses.replace(cfg, method="mpnn")
        problems = loop.kernel_problems(mpnn, "cuda")
        assert len(problems) == 1 and "fp_hidden_dim=64" in problems[0]


def test_kernel_problems_take_d_other_than_h():
    # D != H runs K1 and the plain readout: only H is checked
    cfg = TrainConfig(compute_path="fused", fp_hidden_dim=32, fp_out_dim=16)
    assert loop.kernel_problems(cfg, "cuda") == []


def test_trainer_refuses_an_unbuilt_width_on_cuda_before_any_work():
    cfg = TrainConfig(compute_path="fused", fp_hidden_dim=48, fp_out_dim=48)
    ds = CSVPairParser().parse(pd.read_csv(SAMPLE).head(4)).dataset
    with pytest.raises(ValueError, match="fp_hidden_dim=48"):
        loop.Trainer(cfg, ds, device="cuda")
    # the plain versions take any width
    assert loop.Trainer(cfg, ds, device="cpu").model.encoder.hidden_dim == 48


@pytest.mark.parametrize("flags_", [["--fp-hidden-dim", "48"],
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
    # a run of a packed layout: a padded run runs no kernel (and a config
    # without compute_path is a padded run, TrainConfig's default)
    width = UNBUILT[method]
    config.write_text(json.dumps({"method": method, "sim_method": "hole",
                                  "fp_hidden_dim": width, "fp_out_dim": width,
                                  "conv_layers": 2, "compute_path": "coo"}))
    argv = ["--input", str(tmp_path / "missing.csv"), "--config", str(config),
            "--params", str(tmp_path / "missing.npz"), "--device", "cuda",
            "--out", str(tmp_path / "preds.csv")]
    with pytest.raises(ValueError, match=f"fp_hidden_dim={width}") as e:
        predict.main(argv)
    assert ITEM in str(e.value)
    assert not (tmp_path / "preds.csv").exists()


# ---------------------------------------------------------------------------
# H=128: the forward body is built, the reverse one is not, so the card
# serves GGNN at 128 and refuses to train it


@pytest.mark.parametrize("path", ["coo", "fused", "packed"])
@pytest.mark.parametrize("as_dict", [False, True])
def test_kernel_problems_serve_ggnn_at_128_and_refuse_to_train_it(path, as_dict):
    cfg = TrainConfig(compute_path=path, fp_hidden_dim=128, fp_out_dim=128)
    assert loop.config_problems(cfg) == []
    arg = json.loads(cfg.to_json()) if as_dict else cfg
    assert loop.kernel_problems(arg, "cuda", serving=True) == []
    # D != H serves through K1 and the plain readout
    assert loop.kernel_problems(dataclasses.replace(cfg, fp_out_dim=64), "cuda",
                                serving=True) == []
    problems = loop.kernel_problems(arg, "cuda")
    assert len(problems) == 1
    assert "fp_hidden_dim=128" in problems[0] and ITEM in problems[0]
    assert "built for [16, 32, 64]" in problems[0]
    assert "reverse kernels K1b, K3, K2b are not built" in problems[0]
    assert loop.kernel_problems(arg, "cpu") == []
    assert loop.kernel_problems(arg, "cpu", serving=True) == []


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("method,width,path", [("ggnn", 48, "fused"),
                                               ("mpnn", 64, "coo"),
                                               ("mpnn", 128, "coo")])
def test_kernel_problems_refuse_unbuilt_widths_to_servers_too(serving, method,
                                                              width, path):
    cfg = TrainConfig(method=method, compute_path=path, fp_hidden_dim=width,
                      fp_out_dim=width)
    problems = loop.kernel_problems(cfg, "cuda", serving=serving)
    assert len(problems) == 1
    assert f"fp_hidden_dim={width}" in problems[0] and ITEM in problems[0]
    assert "built for" in problems[0]


def test_trainer_refuses_to_train_h128_on_cuda_before_any_work():
    cfg = TrainConfig(compute_path="fused", fp_hidden_dim=128, fp_out_dim=128)
    ds = CSVPairParser().parse(pd.read_csv(SAMPLE).head(4)).dataset
    with pytest.raises(ValueError, match="fp_hidden_dim=128") as e:
        loop.Trainer(cfg, ds, device="cuda")
    assert ITEM in str(e.value)


@pytest.mark.parametrize("path", ["coo", "fused", "packed"])
def test_train_cli_refuses_h128_on_cuda_before_reading_csvs(tmp_path, path):
    argv = ["--train", str(tmp_path / "missing.csv"),
            "--val", str(tmp_path / "missing_val.csv"), "--compute-path", path,
            "--fp-hidden-dim", "128", "--fp-out-dim", "128", "--device", "cuda",
            "--out", str(tmp_path / "run")]
    with pytest.raises(ValueError, match="fp_hidden_dim=128") as e:
        train_cli.main(argv)
    assert ITEM in str(e.value) and "reverse kernels" in str(e.value)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
@pytest.mark.parametrize("path", ["coo", "fused", "packed"])
def test_serving_clis_take_h128_on_cuda(tmp_path, monkeypatch, cli, path):
    """The predict and evaluate CLIs pass GGNN at 128 on ``--device cuda``:
    the check after the width's is the card's presence (taken away here,
    so the test runs the same with a card), and at 48 the width's check
    refuses first."""
    from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for width, error, match in ((128, RuntimeError, "CUDA is not available"),
                                (48, ValueError, "fp_hidden_dim=48")):
        run = tmp_path / f"run{width}"
        run.mkdir()
        (run / "config.json").write_text(json.dumps({
            "method": "ggnn", "sim_method": "hole", "fp_hidden_dim": width,
            "fp_out_dim": width, "conv_layers": 2, "compute_path": path}))
        if cli == "predict":
            argv = ["--input", str(tmp_path / "missing.csv"), "--config",
                    str(run / "config.json"), "--params",
                    str(tmp_path / "missing.npz"), "--device", "cuda",
                    "--out", str(tmp_path / "preds.csv")]
            main = predict.main
        else:
            argv = ["--test", str(tmp_path / "missing.csv"), "--run", str(run),
                    "--device", "cuda"]
            main = evaluate_cli.main
        with pytest.raises(error, match=match):
            main(argv)
        assert not (tmp_path / "preds.csv").exists()
        assert not (run / "eval").exists()


def test_reverse_kernels_refuse_h128_before_any_launch():
    """The wrappers of K1b, K3 and K2b check the width against the reverse
    body's before any launch; the forward ones take 128."""
    for hidden in tfg.KERNEL_HIDDEN:
        tfg.check_width(hidden)
    for hidden in tfg.REVERSE_HIDDEN:
        tfg.check_width(hidden, reverse=True)
    assert 128 in tfg.KERNEL_HIDDEN and 128 not in tfg.REVERSE_HIDDEN
    assert 128 in tfg.PANEL_HIDDEN
    with pytest.raises(ValueError, match="reverse kernels") as e:
        tfg.check_width(128, reverse=True)
    assert ITEM in str(e.value)
    for reverse in (False, True):
        with pytest.raises(ValueError, match="hidden width 48"):
            tfg.check_width(48, reverse)


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
    # H=64: D = 64 takes K2/K2b, any other D K1 and the plain readout
    flags(False, True, False)
    assert tpacked.fused_form(64, 64).startswith("K2/K2b")
    assert tpacked.readout_in_kernel(64, 64)
    for d in (16, 32, 128):
        assert tpacked.fused_form(64, d).startswith("K1/K1b")
        assert not tpacked.readout_in_kernel(64, d)


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
