"""The port's serving slice against the JAX package, end to end on the CPU:
weights made with numpy from a seed, carried into both through the flax
param tree, and the same wire-compact batches fed to both."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.data.packing import pack_pair_dataset_coo
from gcnbmp_tpu.data.parsers import CSVPairParser
from gcnbmp_tpu.eval.evaluate import PackedPairEvaluator as JaxEvaluator
from gcnbmp_tpu.models import packed as jpacked
from gcnbmp_tpu.models.layers import ChainerGRUCell as JaxGRU
from gcnbmp_tpu.models.layers import EmbedAtomID as JaxEmbed
from gcnbmp_tpu.train.config import TrainConfig
from gcnbmp_tpu_torch.cli import predict
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_params, load_params_npz, save_params_npz)
from gcnbmp_tpu_torch.data.wire import compact_coo_arrays
from gcnbmp_tpu_torch.eval.evaluate import PackedPairEvaluator
from gcnbmp_tpu_torch.models.layers import ChainerGRUCell, EmbedAtomID
from gcnbmp_tpu_torch.models.packed import make_packed_predictor
from gcnbmp_tpu_torch.ops.aggregate import adj_from_coo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
RTOL, ATOL = 1e-4, 1e-5


def _dataset(n):
    return CSVPairParser().parse(pd.read_csv(SAMPLE).head(n)).dataset


def _cfg(layers, hidden, tied, **kw):
    return dict(fp_hidden_dim=hidden, fp_out_dim=hidden, conv_layers=layers,
                weight_tying=tied, **kw)


def _jax_predictor(cfg):
    return jpacked.make_packed_predictor(**cfg, coo=True, compact=True)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("tied", [True, False])
def test_param_tree_matches_flax(tied):
    cfg = _cfg(3, 16, tied, net_hidden_dims=(8,), class_num=2)
    batch = pack_pair_dataset_coo(_dataset(4), list(range(4)))
    args = [jnp.asarray(a) for a in compact_coo_arrays(batch)]
    flax_tree = _jax_predictor(cfg).init(jax.random.PRNGKey(0), *args)["params"]
    tree = init_params(cfg, seed=0)
    assert _shapes(tree) == _shapes(flax_tree)
    model = from_jax_params(tree, make_packed_predictor(**cfg))
    np.testing.assert_array_equal(model.encoder.gru.W_z.weight.detach().numpy(),
                                  tree["encoder"]["gru"]["W_z"]["kernel"].T)


@pytest.mark.parametrize("layers,hidden,tied", [(3, 16, True), (3, 16, False),
                                                (8, 32, False)])
def test_slice_logits_match_jax(layers, hidden, tied):
    cfg = _cfg(layers, hidden, tied)
    batch = pack_pair_dataset_coo(_dataset(24), list(range(24)))
    wire = compact_coo_arrays(batch)
    tree = init_params(cfg, seed=layers)
    want = _jax_predictor(cfg).apply(
        {"params": tree}, *(jnp.asarray(a) for a in wire), return_g=True)
    model = from_jax_params(tree, make_packed_predictor(**cfg))
    with torch.no_grad():
        got = model(*(torch.as_tensor(np.asarray(a)) for a in wire),
                    return_g=True)
    for name, a, b in zip(("logits", "g1", "g2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_plain_encoder_matches_jax_packed_ggnn():
    cfg = _cfg(3, 16, False)
    batch = pack_pair_dataset_coo(_dataset(8), list(range(8)))
    adj = batch.to_dense().adj
    tree = init_params(cfg, seed=9)
    enc = jpacked.PackedGGNN(out_dim=16, hidden_dim=16, n_layers=3,
                             weight_tying=False)
    want, _ = enc.apply({"params": tree["encoder"]}, jnp.asarray(batch.atom_ids),
                        jnp.asarray(adj), jnp.asarray(batch.mol_id),
                        jnp.asarray(batch.node_mask), batch.num_mols)
    model = from_jax_params(tree, make_packed_predictor(**cfg))
    p, t = batch.atom_ids.shape
    t_adj = adj_from_coo(*(torch.as_tensor(a) for a in (
        batch.e_tile, batch.e_type, batch.e_src, batch.e_dst, batch.e_mask)),
        num_tiles=p, tile=t)
    np.testing.assert_array_equal(t_adj.numpy(), adj)
    with torch.no_grad():
        got, _ = model.encoder(torch.as_tensor(batch.atom_ids), t_adj,
                               torch.as_tensor(batch.mol_id),
                               torch.as_tensor(batch.node_mask), batch.num_mols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_layers_match_jax():
    rng = np.random.default_rng(11)
    ids = np.array([[0, 5, 116, 117, 300, -4]], np.int32)  # clamped out of range
    emb = rng.standard_normal((117, 8)).astype(np.float32)
    want = JaxEmbed(117, 8).apply({"params": {"embedding": emb}}, jnp.asarray(ids))
    m = EmbedAtomID(117, 8)
    from_jax_params({"embedding": emb}, m)
    np.testing.assert_array_equal(m(torch.as_tensor(ids)).detach().numpy(),
                                  np.asarray(want))

    h = rng.standard_normal((5, 8)).astype(np.float32)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    gru_tree = {n: {"kernel": rng.standard_normal((16 if n[0] == "W" else 8, 8))
                    .astype(np.float32) * 0.3,
                    "bias": rng.standard_normal(8).astype(np.float32) * 0.1}
                for n in ("W_z", "U_z", "W_r", "U_r", "W", "U")}
    want = JaxGRU(8).apply({"params": gru_tree}, jnp.asarray(h), jnp.asarray(x))
    gru = from_jax_params(gru_tree, ChainerGRUCell(16, 8))
    got = gru(torch.as_tensor(h), torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_npz_round_trip(tmp_path):
    tree = init_params(_cfg(2, 16, False), seed=3)
    path = str(tmp_path / "p.npz")
    save_params_npz(path, tree)
    back = load_params_npz(path)
    assert _shapes(back) == _shapes(tree)
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


def _serving_setup(n=32):
    cfg = TrainConfig(method="ggnn", sim_method="hole", conv_layers=3,
                      fp_hidden_dim=16, fp_out_dim=16, weight_tying=False,
                      compute_path="fused")
    kwargs = predict.model_kwargs_from_config(json.loads(cfg.to_json()))
    tree = init_params(kwargs, seed=7)
    ds = _dataset(n)
    want = JaxEvaluator(cfg, tree, batch_size=12).evaluate(ds)
    return cfg, kwargs, tree, ds, want


def test_evaluator_matches_jax(tmp_path):
    _, kwargs, tree, ds, want = _serving_setup()
    model = from_jax_params(tree, make_packed_predictor(**kwargs))
    got = PackedPairEvaluator(model, batch_size=12, device="cpu").evaluate(ds)
    assert len(got.logits) == 32
    for name in ("logits", "e1", "e2"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_predict_cli_matches_jax(tmp_path):
    cfg, _, tree, _, want = _serving_setup()
    (tmp_path / "config.json").write_text(cfg.to_json())
    save_params_npz(str(tmp_path / "params.npz"), tree)
    pd.read_csv(SAMPLE).head(32).to_csv(tmp_path / "in.csv", index=False)
    rc = predict.main([
        "--input", str(tmp_path / "in.csv"), "--out", str(tmp_path / "out.csv"),
        "--config", str(tmp_path / "config.json"),
        "--params", str(tmp_path / "params.npz"),
        "--batch-size", "12", "--device", "cpu"])
    assert rc == 0
    out = pd.read_csv(tmp_path / "out.csv")
    assert len(out) == 32
    np.testing.assert_allclose(out["prob"].to_numpy(),
                               1.0 / (1.0 + np.exp(-want.logits)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("field,changes", [
    ("method", {"method": "weavenet"}),
    ("layer_aggregator", {"method": "relgcn", "layer_aggregator": "gru"}),
    ("layer_aggregator", {"layer_aggregator": "self-attn"}),
    ("concat_hidden", {"concat_hidden": True}),
    ("symmetric", {"symmetric": "or"})])
def test_config_outside_slice_raises(field, changes):
    d = {**json.loads(TrainConfig().to_json()), **changes}
    with pytest.raises(ValueError, match=field):
        predict.model_kwargs_from_config(d)
