"""The graph auto-encoder of the port (``gcnbmp_tpu_torch.models.gae``)
against the JAX package's on the CPU: ``normalize_adj``,
``mask_test_edges``, ``parse_edge_csv`` and ``mask_test_edges_from_splits``
exact; the GAE's logits and embeddings for one relation and for three
(1e-5); ``train_gae`` from the JAX function's initial tree at dropout 0
(embeddings 1e-4), its ROC-AUC and AP equal to scikit-learn's on its own
embeddings (1e-6); the seeded initial draw and dropout."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.models import gae as jgae
from gcnbmp_tpu_torch.convert import from_jax_params, to_jax_params
from gcnbmp_tpu_torch.models import gae
from gcnbmp_tpu_torch.train import metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "dataset", "sample", "sample200.csv")
TOL = 1e-5


def _adjacency(n=60, density=0.12, seed=0):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < density, k=1)
    return (upper | upper.T).astype(np.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_normalize_adj_exact():
    adj = _adjacency()
    adj[3] = adj[:, 3] = 0  # an isolated node
    got, want = gae.normalize_adj(adj), jgae.normalize_adj(adj)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,val_frac,test_frac", [(0, 0.05, 0.10),
                                                     (3, 0.2, 0.2)])
def test_mask_test_edges_exact(seed, val_frac, test_frac):
    adj = _adjacency(seed=seed)
    got = gae.mask_test_edges(adj, val_frac, test_frac, seed)
    want = jgae.mask_test_edges(adj, val_frac, test_frac, seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["val_pos"]) > 0 and len(got["test_neg"]) > 0


def test_parse_edge_csv_and_splits_exact(tmp_path):
    df = pd.read_csv(SAMPLE)
    ids = sorted(set(df.cid_1) | set(df.cid_2))
    id2ind = {c: i for i, c in enumerate(ids)}
    got = gae.parse_edge_csv(SAMPLE, id2ind)
    want = jgae.parse_edge_csv(SAMPLE, id2ind)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # integer drugbank ids, no map
    num = tmp_path / "num.csv"
    pd.DataFrame({"drugbank_id_1": [0, 1, 2, 3], "drugbank_id_2": [1, 2, 3, 0],
                  "label": [1, 0, 1, 0]}).to_csv(num, index=False)
    for a, b in zip(gae.parse_edge_csv(str(num)), jgae.parse_edge_csv(str(num))):
        np.testing.assert_array_equal(a, b)
    pos, neg = got
    args = (len(ids), pos[:20], pos[20:25], neg[:5], pos[25:30], neg[5:10])
    s_got = gae.mask_test_edges_from_splits(*args)
    s_want = jgae.mask_test_edges_from_splits(*args)
    for k in s_want:
        assert s_got[k].dtype == s_want[k].dtype, k
        np.testing.assert_array_equal(s_got[k], s_want[k], err_msg=k)


@pytest.mark.parametrize("n_relations", [1, 3])
def test_gae_logits_match_jax(n_relations):
    n = 40
    adj_norm = jgae.normalize_adj(_adjacency(n))
    x = np.random.default_rng(1).standard_normal((n, 7)).astype(np.float32)
    jm = jgae.GAE(16, 8, 0.0, n_relations)
    params = _numpy_tree(jm.init(jax.random.PRNGKey(0), x, adj_norm)["params"])
    if n_relations > 1:  # leave the all-ones init
        params["relation_diag"] = np.random.default_rng(2).uniform(
            0.5, 1.5, params["relation_diag"].shape).astype(np.float32)
    want_logits, want_z = jm.apply({"params": params}, x, adj_norm)
    model = gae.GAE(7, 16, 8, 0.0, n_relations)
    from_jax_params(params, model)
    logits, z = model(torch.from_numpy(x), torch.from_numpy(adj_norm))
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(z.detach().numpy(), want_z, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=TOL, rtol=TOL)
    back = to_jax_params(model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_train_gae_from_the_jax_init_matches_jax():
    pytest.importorskip("sklearn")
    from sklearn import metrics as skm

    adj = _adjacency(n=60, seed=4)
    n = adj.shape[0]
    kw = dict(hidden1=16, hidden2=8, dropout=0.0, learning_rate=0.01,
              epochs=60, seed=5, val_frac=0.1, test_frac=0.15)
    want = jgae.train_gae(adj, **kw)
    masked = jgae.mask_test_edges(adj, 0.1, 0.15, 5)
    init = jgae.GAE(16, 8, 0.0).init(
        jax.random.PRNGKey(5), jnp.eye(n, dtype=jnp.float32),
        jnp.asarray(jgae.normalize_adj(masked["adj_train"])))["params"]
    got = gae.train_gae(adj, device="cpu", params=_numpy_tree(init), **kw)
    np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                               atol=1e-4, rtol=0)
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-5
    z = got["embeddings"]
    for split in ("val", "test"):
        pos, neg = masked[f"{split}_pos"], masked[f"{split}_neg"]
        scores = np.concatenate([np.sum(z[pos[:, 0]] * z[pos[:, 1]], axis=1),
                                 np.sum(z[neg[:, 0]] * z[neg[:, 1]], axis=1)])
        y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
        probs = 1 / (1 + np.exp(-scores))
        assert abs(got[split]["roc_auc"]
                   - skm.roc_auc_score(y, probs)) <= 1e-6
        assert abs(got[split]["ap"]
                   - skm.average_precision_score(y, probs)) <= 1e-6


def test_average_precision_equals_sklearn_with_ties():
    pytest.importorskip("sklearn")
    from sklearn import metrics as skm

    rng = np.random.default_rng(6)
    y = rng.integers(0, 2, 300)
    score = np.round(rng.random(300), 1)  # many ties
    assert abs(metrics.average_precision(y, score)
               - skm.average_precision_score(y, score)) <= 1e-12


def test_train_gae_seeded_draw_splits_and_dropout():
    adj = _adjacency(n=50, seed=7)
    model = gae.GAE(50, 16, 8, n_relations=2)
    tree = gae.init_gae_params(model, 0)
    limit = np.sqrt(6.0 / (50 + 16))
    k1 = tree["encoder"]["gc1"]["kernel"]
    assert k1.shape == (50, 16) and np.abs(k1).max() <= limit
    np.testing.assert_array_equal(tree["relation_diag"], np.ones((2, 8)))
    a = gae.train_gae(adj, hidden1=16, hidden2=8, dropout=0.1, epochs=20,
                      seed=1, device="cpu")
    b = gae.train_gae(adj, hidden1=16, hidden2=8, dropout=0.1, epochs=20,
                      seed=1, device="cpu")
    np.testing.assert_array_equal(a["embeddings"], b["embeddings"])
    assert np.isfinite(a["final_loss"])
    assert 0.0 <= a["val"]["roc_auc"] <= 1.0 and 0.0 <= a["test"]["ap"] <= 1.0
    pos = np.argwhere(np.triu(adj, 1) > 0)
    neg = np.argwhere(np.triu(1 - adj, 1) > 0)[:10]
    splits = gae.mask_test_edges_from_splits(
        50, pos[:-10], pos[-10:-5], neg[:5], pos[-5:], neg[5:])
    c = gae.train_gae(adj, hidden1=16, hidden2=8, dropout=0.0, epochs=5,
                      splits=splits, device="cpu")
    assert c["embeddings"].shape == (50, 8)
