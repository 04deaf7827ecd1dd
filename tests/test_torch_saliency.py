"""Atom saliency of the port (``gcnbmp_tpu_torch.eval.saliency``) against
the JAX package's on the CPU, on the same params carried across and a
padded batch of synth546 drug train pairs:

- ``gradient`` and ``integrated`` maps of GGNN (siamese, ``siamese=False``,
  co-attention ``para``), RelGCN, GIN, NFP and MPNN against JAX's
  ``atom_saliency`` within atol 1e-5 + rtol 1e-4;
- ``bayes`` through the gradient function: the port's maps against JAX's
  gradient function evaluated at the port's noise points (the draw of a
  CPU ``torch.Generator``; ``jax.random`` draws other points), and the two
  gradient functions at a given point;
- ``siamese=False`` embeds side 2 with ``encoder``'s table in both
  packages (a reference caveat, ROADMAP queue 3);
- a GWM predictor refused as JAX refuses it (no supernode features);
- ``render_molecule_svg`` string-equal to JAX's, with and without values.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gcnbmp_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.data.parsers import CSVPairParser as JCSVPairParser
from gcnbmp_tpu.eval import saliency as jsaliency
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu_torch.chem import mol_from_smiles
from gcnbmp_tpu_torch.convert import from_jax_params
from gcnbmp_tpu_torch.data import CSVPairParser
from gcnbmp_tpu_torch.data.dataset import make_batch
from gcnbmp_tpu_torch.eval import saliency
from gcnbmp_tpu_torch.models.predictor import set_up_predictor

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = os.path.join(ROOT, "dataset", "synth546", "drug", "ddi_drug_train.csv")
ATOL, RTOL = 1e-5, 1e-4
BASE = dict(fp_hidden_dim=8, fp_out_dim=8, conv_layers=2)
MODELS = [
    ("ggnn", dict(weight_tying=False)),
    ("ggnn-not-siamese", dict(siamese=False)),
    ("ggnn-para-ntn", dict(attn_model="para", sim_method="ntn")),
    ("relgcn", dict(method="relgcn")),
    ("gin", dict(method="gin")),
    ("nfp", dict(method="nfp")),
    ("mpnn", dict(method="mpnn")),
]
NAMES = ("atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")


@pytest.fixture(scope="module")
def frame():
    return pd.read_csv(PAIRS).head(5)


@pytest.fixture(scope="module")
def batch(frame):
    ds = JCSVPairParser().parse(frame).dataset
    return jmake_batch(ds, list(range(5)))


_CACHE = {}


def _models(kw, batch):
    """(JAX predictor, its params, the port's predictor holding them),
    built once per configuration."""
    key = repr(sorted(kw.items()))
    if key not in _CACHE:
        _CACHE[key] = _build(kw, batch)
    return _CACHE[key]


def _build(kw, batch):
    kw = dict(BASE, **kw)
    jmodel = jset_up_predictor(**kw)
    args = [jnp.asarray(getattr(batch, n)) for n in NAMES]
    params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]
    # non-zero biases, so every term shows in the gradients
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(2), x.shape),
        params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, from_jax_params(tree, set_up_predictor(**kw))


def _close(got, want):
    for side in ("mol1", "mol2"):
        assert got[side].shape == want[side].shape
        np.testing.assert_allclose(got[side], np.asarray(want[side]),
                                   atol=ATOL, rtol=RTOL, err_msg=side)


def test_port_batch_equals_the_jax_batch(frame, batch):
    ds = CSVPairParser().parse(frame).dataset
    got = make_batch(ds, list(range(5)))
    for n in NAMES:
        np.testing.assert_array_equal(getattr(got, n), getattr(batch, n))


@pytest.mark.parametrize("method", ["gradient", "integrated"])
@pytest.mark.parametrize("name,kw", MODELS, ids=[m[0] for m in MODELS])
def test_saliency_matches_jax(batch, name, kw, method):
    jmodel, params, model = _models(kw, batch)
    args = [getattr(batch, n) for n in NAMES]
    want = jsaliency.atom_saliency(jmodel, params, *args, method=method,
                                   steps=4)
    got = saliency.atom_saliency(model, *args, method=method, steps=4)
    _close(got, want)
    assert np.all(got["mol1"][batch.mask1 == 0] == 0)
    assert np.any(got["mol1"] > 0) and np.any(got["mol2"] > 0)


@pytest.mark.parametrize("name,kw", MODELS, ids=[m[0] for m in MODELS])
def test_bayes_matches_jax_at_the_same_noise_points(batch, name, kw):
    jmodel, params, model = _models(kw, batch)
    args = [getattr(batch, n) for n in NAMES]
    got = saliency.atom_saliency(model, *args, method="bayes", n_samples=3,
                                 noise_scale=0.2,
                                 generator=torch.Generator().manual_seed(9))
    # the JAX gradient function at the port's noise points
    if name == "relgcn":
        jmodel = jmodel.clone(encoder=jmodel.encoder.clone(pre_embedded=True))
    jgrad, jembed = jsaliency.embedding_grad_fn(
        jmodel, params, batch.adj1, batch.adj2, batch.mask1, batch.mask2)
    h1, h2 = jembed(batch.atoms1), jembed(batch.atoms2)
    gen = torch.Generator().manual_seed(9)
    g1, g2 = jnp.zeros_like(h1), jnp.zeros_like(h2)
    for _ in range(3):
        n1 = jnp.asarray(torch.randn(h1.shape, generator=gen).numpy())
        n2 = jnp.asarray(torch.randn(h2.shape, generator=gen).numpy())
        d1, d2 = jgrad(h1 + 0.2 * n1, h2 + 0.2 * n2)
        g1, g2 = g1 + jnp.abs(d1), g2 + jnp.abs(d2)
    want = {"mol1": np.linalg.norm(np.asarray(g1 / 3 * h1), axis=-1),
            "mol2": np.linalg.norm(np.asarray(g2 / 3 * h2), axis=-1)}
    _close(got, want)
    # the two gradient functions at one given point
    with saliency._pre_embedded(model):
        grad, embed = saliency.embedding_grad_fn(
            model, batch.adj1, batch.adj2, batch.mask1, batch.mask2)
        p1 = embed(batch.atoms1) * 0.7 + 0.05
        p2 = embed(batch.atoms2) * 1.3 - 0.05
        got_g = grad(p1, p2)
    want_g = jgrad(jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()))
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)
    # the default generator is seeded: two calls give the same map
    again = [saliency.atom_saliency(model, *args, method="bayes",
                                    n_samples=2) for _ in range(2)]
    np.testing.assert_array_equal(again[0]["mol1"], again[1]["mol1"])


def test_not_siamese_embeds_side_two_with_the_encoders_table(batch):
    """The reference caveat: both packages embed side 2 with
    ``encoder/embed``, not ``encoder2/embed``, so its map is taken at
    the other encoder's embedding of the atoms."""
    jmodel, params, model = _models(dict(siamese=False), batch)
    t1 = model.encoder.embed.embedding.detach()
    t2 = model.encoder2.embed.embedding.detach()
    assert not torch.equal(t1, t2)
    args = [getattr(batch, n) for n in NAMES]
    got = saliency.atom_saliency(model, *args, method="gradient")
    _close(got, jsaliency.atom_saliency(jmodel, params, *args,
                                        method="gradient"))

    def side2(table):
        h1 = t1[torch.as_tensor(batch.atoms1).long()]
        h2 = table[torch.as_tensor(batch.atoms2).long()]
        grad, _ = saliency.embedding_grad_fn(
            model, batch.adj1, batch.adj2, batch.mask1, batch.mask2)
        return np.linalg.norm((grad(h1, h2)[1] * h2).numpy(), axis=-1)

    np.testing.assert_array_equal(got["mol2"], side2(t1))
    assert not np.allclose(got["mol2"], side2(t2))


def test_gwm_predictor_refused_as_jax_refuses_it(batch):
    model = set_up_predictor(method="ggnn-gwm", **BASE)
    args = [getattr(batch, n) for n in NAMES]
    with pytest.raises(ValueError, match="supernode features"):
        saliency.atom_saliency(model, *args)
    # the JAX predictor refuses before it reads any parameter but the
    # embedding table that saliency looks up
    jmodel = jset_up_predictor(method="ggnn-gwm", **BASE)
    params = {"encoder": {"embed": {"embedding": np.zeros((117, 8),
                                                          np.float32)}}}
    with pytest.raises(ValueError, match="supernode features"):
        jsaliency.atom_saliency(jmodel, params, *args)
    with pytest.raises(ValueError, match="unknown saliency method"):
        saliency.atom_saliency(set_up_predictor(**BASE), *args, method="x")


def test_render_molecule_svg_string_equal(frame):
    smiles = list(frame.smiles_1) + list(frame.smiles_2) + ["C", "C#N"]
    rng = np.random.default_rng(3)
    for s in smiles:
        jm, m = jax_mol_from_smiles(s), mol_from_smiles(s)
        np.testing.assert_array_equal(saliency.layout_2d(m),
                                      jsaliency.layout_2d(jm))
        values = rng.random(m.num_atoms + 3)
        assert (saliency.render_molecule_svg(m, values)
                == jsaliency.render_molecule_svg(jm, values))
        assert (saliency.render_molecule_svg(m)
                == jsaliency.render_molecule_svg(jm))
        assert (saliency.render_molecule_svg(m, np.zeros(m.num_atoms), 200)
                == jsaliency.render_molecule_svg(jm, np.zeros(m.num_atoms),
                                                 200))
