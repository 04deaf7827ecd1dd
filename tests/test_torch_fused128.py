"""The h=128 fused model (``GCNBMP_BENCH_HIDDEN=128``'s GGNN, bench.py:137,
with H = D = 128) on the CPU, cut to L=2 and a few dozen pairs of
dataset/synth546's drug test split, against the JAX package:

- the plain versions of K1, K1m and K2 (what the port's wrappers run on
  the CPU, and what chip_smoke.py holds the H=128 CUDA body against on the
  card) against the JAX ``fused_ggnn``, its TWOPASS form (``_fused_ggnn_fwd``
  and its h_mid) and ``fused_ggnn_readout`` in interpret mode, on one
  packed batch of the split with the model's weights;
- the predict CLI (``--config/--params``) against the JAX
  ``PackedPairEvaluator`` on the same weights, carried across by
  ``convert``, in the port's K2 form and under ``GCNBMP_FUSED_READOUT=0``
  (K1 and the plain readout), each form's kernel function called once per
  request;
- the evaluate CLI's metrics against the JAX ``evaluate_dataset`` on the
  same run, on pairs without repeats (a repeated pair is a tie in one
  package and not in the other; tests/test_torch_evaluate.py).

The H=128 CUDA forward body itself runs on the CPU stand-in in
tests/test_torch_fwd_emulated128.py and on the card in chip_smoke.py
(phases 3a and 20)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gcnbmp_tpu.eval import evaluate as jeval
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.ops import fused_ggnn as jfg
from gcnbmp_tpu.train.config import TrainConfig as JaxTrainConfig
from gcnbmp_tpu_torch.cli import evaluate as evaluate_cli
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.convert import from_jax_params, init_params, save_params_npz
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.models import packed as tpacked
from gcnbmp_tpu_torch.models.packed import (
    decode_compact_wire, make_packed_predictor, model_kwargs_from_config)
from gcnbmp_tpu_torch.ops import fused_ggnn as tfg
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo_flat

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CSV = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_test.csv")
TOL = 1e-5
N_PAIRS = 48
BATCH = 16
# the bench model (bench.py:137) at H = D = 128, cut to L=2
CFG = JaxTrainConfig(method="ggnn", sim_method="hole", conv_layers=2,
                     fp_hidden_dim=128, fp_out_dim=128, weight_tying=False,
                     compute_path="fused", batch_size=BATCH)
KWARGS = model_kwargs_from_config(json.loads(CFG.to_json()))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The split's first N_PAIRS pairs, each (smiles_1, smiles_2) once."""
    path = tmp_path_factory.mktemp("fused128") / "pairs.csv"
    df = pd.read_csv(TEST_CSV).head(N_PAIRS)
    df = df.drop_duplicates(["smiles_1", "smiles_2"])
    assert len(df) > N_PAIRS // 2 and len(set(df["label"])) == 2
    df.to_csv(path, index=False)
    return str(path)


@pytest.fixture(scope="module")
def tree():
    return init_params(KWARGS, seed=128)


@pytest.fixture
def forms():
    """Set the port's and the JAX package's form flags for one test."""
    saved = (tpacked.FUSED_READOUT, tfg.TWOPASS, jfg.TWOPASS)
    yield
    tpacked.FUSED_READOUT, tfg.TWOPASS, jfg.TWOPASS = saved


def _kernel_inputs(tree, pairs):
    """The K1 arguments of the model's first packed batch of 16 pairs (h0
    the atoms' embeddings, the flat adjacency, the fused weights) and K2's
    readout, as torch tensors."""
    ds = CSVPairParser().parse(pd.read_csv(pairs).head(BATCH)).dataset
    batch = pack_pair_dataset_coo(ds, list(range(len(ds))))
    nodes, e_packed, n_edges, left, _ = (
        torch.as_tensor(np.asarray(a)) for a in compact_coo_arrays(batch))
    atom_ids, _, mask, *edges = decode_compact_wire(nodes, e_packed, n_edges,
                                                    2 * left.shape[0])
    p, t = atom_ids.shape
    model = from_jax_params(tree, make_packed_predictor(**KWARGS))
    enc = model.encoder
    msg_w, msg_b, gru = tfg.params_to_fused(enc)
    ro = enc.readout_0
    with torch.no_grad():
        args = (enc.n_layers, enc.embed(atom_ids), adj_from_coo_flat(
            *edges, num_tiles=p, tile=t), msg_w, msg_b, gru)
        readout = (mask.float(), ro.i.dense.weight.T.contiguous(), ro.i.dense.bias,
                   ro.j.dense.weight.T.contiguous(), ro.j.dense.bias)
    assert args[1].shape[-1] == 128 and p >= 2
    return ([a.detach() if isinstance(a, torch.Tensor) else
             {k: v.detach() for k, v in a.items()} if isinstance(a, dict) else a
             for a in args], [r.detach() for r in readout])


def _jax(x):
    if isinstance(x, dict):
        return {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels


def test_k1_and_k1m_plain_match_jax_at_h128(tree, pairs, forms):
    args, _ = _kernel_inputs(tree, pairs)
    jargs = [_jax(a) for a in args]
    jfg.TWOPASS = True
    with pltpu.force_tpu_interpret_mode():
        want = jfg.fused_ggnn(*jargs)
        want_h, res = jfg._fused_ggnn_fwd(*jargs)
    with torch.no_grad():
        got = tfg.fused_ggnn(*args)
        got_h, got_mid = tfg.fused_ggnn_mid(*args)
    _close(got, want, "K1")
    _close(got_h, want_h, "K1m h")
    _close(got_mid, res[-1], "K1m h_mid")
    assert torch.equal(got_h, got)


def test_k2_plain_matches_jax_at_h128(tree, pairs):
    args, readout = _kernel_inputs(tree, pairs)
    with pltpu.force_tpu_interpret_mode():
        want = jfg.fused_ggnn_readout(*(_jax(a) for a in args),
                                      *(_jax(r) for r in readout))
    with torch.no_grad():
        got = tfg.fused_ggnn_readout(*args, *readout)
    _close(got, want, "K2")


# ---------------------------------------------------------------------------
# the CLIs against the JAX evaluator


def _logits(probs):
    p = np.asarray(probs, np.float64)
    return np.log(p) - np.log1p(-p)


@pytest.mark.parametrize("fused_readout", [True, False],
                         ids=["K2", "K1_plain_readout"])
def test_predict_cli_at_h128_matches_jax(tmp_path, tree, pairs, forms,
                                         monkeypatch, fused_readout):
    tpacked.FUSED_READOUT = fused_readout
    assert tpacked.fused_form(128, 128).startswith(
        "K2/K2b" if fused_readout else "K1/K1b")
    calls = {"K1": 0, "K2": 0}
    for name, key in (("_fused_ggnn_fwd", "K1"), ("_fused_ggnn_readout_fwd", "K2")):
        fn = getattr(tfg, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(tfg, name, counted)
    (tmp_path / "config.json").write_text(CFG.to_json())
    save_params_npz(str(tmp_path / "params.npz"), tree)
    assert predict.main([
        "--input", pairs, "--out", str(tmp_path / "out.csv"),
        "--config", str(tmp_path / "config.json"),
        "--params", str(tmp_path / "params.npz"),
        "--batch-size", str(BATCH), "--device", "cpu"]) == 0
    out = pd.read_csv(tmp_path / "out.csv")
    ds = CSVPairParser().parse(pd.read_csv(pairs)).dataset
    with pltpu.force_tpu_interpret_mode():
        want = jeval.PackedPairEvaluator(CFG, tree, batch_size=BATCH).evaluate(ds)
    assert len(out) == len(ds) == len(want.logits)
    np.testing.assert_allclose(_logits(out["prob"]), np.ravel(want.logits),
                               rtol=TOL, atol=TOL)
    requests = -(-len(ds) // BATCH)
    assert calls == ({"K1": 0, "K2": requests} if fused_readout
                     else {"K1": requests, "K2": 0})


def test_evaluate_cli_at_h128_matches_jax_evaluate_dataset(tmp_path, tree,
                                                           pairs, capsys):
    run = tmp_path / "run"
    os.makedirs(run / "best")
    (run / "config.json").write_text(CFG.to_json())
    save_params_npz(str(run / "best" / "params.npz"), tree)
    out = tmp_path / "eval"
    assert evaluate_cli.main(["--test", pairs, "--run", str(run),
                              "--batch-size", str(BATCH), "--out", str(out),
                              "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads((out / "eval_result.json").read_text())
    assert printed == got
    res = CSVPairParser().parse(pairs)
    with pltpu.force_tpu_interpret_mode():
        want = jeval.evaluate_dataset(
            None, tree, res.dataset, out_dir=str(tmp_path / "jax"),
            source_csv=pairs, batch_size=BATCH, class_num=1,
            is_successful=res.is_successful, train_cfg=CFG).metrics
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL, err_msg=key)
