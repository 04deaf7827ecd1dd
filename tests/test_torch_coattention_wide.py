"""Each of the 15 co-attention variants in the padded predictor over
molecule embeddings of another width than ``fp_out_dim``: L·D (GGNN with
``concat_hidden``) and H (GGNN-dev's sum pool), logits and every gradient
against the JAX predictor on the CPU; ``alter`` and ``circ``, which the
JAX modules cannot run there, refused with the JAX error quoted.  A file
of its own, split from tests/test_torch_coattention.py (whose helpers it
takes), so that pytest-xdist's ``--dist loadfile`` runs these 30 cases
beside the rest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcnbmp_tpu.data.dataset import make_batch as jmake_batch
from gcnbmp_tpu.models import set_up_predictor as jset_up_predictor
from gcnbmp_tpu_torch.convert import from_jax_params, init_params
from gcnbmp_tpu_torch.models.predictor import set_up_predictor
from gcnbmp_tpu_torch.train import loop
from gcnbmp_tpu_torch.train.config import TrainConfig
from test_torch_coattention import (
    ATOL, RTOL, VARIANTS, _assert_grads, _dataset, _flat, _param_grads,
    _shapes)

torch.set_num_threads(1)


WIDE = {"concat_hidden": dict(method="ggnn", concat_hidden=True),
        "ggnn-dev": dict(method="ggnn-dev")}


@pytest.mark.parametrize("wide", WIDE)
@pytest.mark.parametrize("name", VARIANTS)
def test_variant_over_wide_molecule_embeddings_matches_jax(name, wide):
    """g is 2 * 6 = 12 wide under concat_hidden (L=2, D=6) and H = 8 under
    GGNN-dev's sum pool: the port's co-attention reads g at its width, as
    flax infers it.  ``alter`` and ``circ`` raise in the JAX package at
    such a width; the port refuses them with that error, quoted."""
    kw = dict(fp_hidden_dim=8, fp_out_dim=6, conv_layers=2, sim_method="ntn",
              net_hidden_dims=(4,), attn_model=name, **WIDE[wide])
    jb = jmake_batch(_dataset(4), list(range(4)))
    names = ("atoms1", "adj1", "atoms2", "adj2", "mask1", "mask2")
    jargs = [jnp.asarray(getattr(jb, n)) for n in names]
    targs = [torch.as_tensor(getattr(jb, n)) for n in names]
    jpred = jset_up_predictor(**kw)
    n_max = jb.atoms1.shape[1]
    if name in ("alter", "circ"):
        with pytest.raises(Exception) as jerr:
            jpred.init(jax.random.PRNGKey(0), *jargs)
        with pytest.raises(ValueError) as err:
            set_up_predictor(**kw)
        g, b = (12 if wide == "concat_hidden" else 8), len(jb.labels)
        if name == "alter":
            frag = ("expected to generate shape (14, 8), but the existing "
                    f"parameter it received has shape ({g + 8}, 8)")
            port = frag
        else:
            frag = (f"Incompatible shapes for broadcasting: ({b}, 1, {g}) "
                    f"and requested shape ({b}, {n_max}, 6)")
            port = frag.replace(f"({b}, 1,", "(B, 1,").replace(
                f"({b}, {n_max},", "(B, N,")
        assert frag in str(jerr.value) and port in str(err.value)
        assert loop.padded_model_problems(TrainConfig(
            **{k: v for k, v in kw.items() if k != "attn_model"},
            attn=name)) == [str(err.value)]
        return
    tree = init_params(dict(kw, coattn_n_max=n_max), seed=len(name),
                       padded=True)
    flax_tree = jpred.init(jax.random.PRNGKey(0), *jargs)["params"]
    assert _shapes(tree) == _shapes(flax_tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = np.asarray(jpred.apply({"params": params}, *jargs))
    w = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    want_grads = jax.grad(lambda p: jnp.sum(
        jpred.apply({"params": p}, *jargs) * w))(params)
    model = from_jax_params(tree, set_up_predictor(**kw, coattn_n_max=n_max))
    assert model.encoder.out_width == (12 if wide == "concat_hidden" else 8)
    got = model(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (got * torch.as_tensor(w)).sum().backward()
    _assert_grads(_param_grads(model), _flat(want_grads))
