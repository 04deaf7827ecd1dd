"""The port's six scoring heads and its Bilinear layer against the JAX
package on the CPU: weights from ``convert.init_module_params`` with a
seed, inputs from numpy with a seed; outputs, and the gradients of every
parameter and both inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcnbmp_tpu.models.heads import HEADS as JAX_HEADS
from gcnbmp_tpu.models.layers import Bilinear as JaxBilinear
from gcnbmp_tpu_torch.convert import (
    from_jax_params, init_module_params, named_to_tree)
from gcnbmp_tpu_torch.models.heads import make_head
from gcnbmp_tpu_torch.models.layers import Bilinear

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5              # outputs
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6    # per tensor, times max|want|
B, D = 6, 8


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[k] - w).max()) if w.size else 0.0
        bound = GRAD_RTOL * float(np.abs(w).max(initial=0.0)) + GRAD_ATOL
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


def _check(module, jax_module, tree, seed, out_dim):
    """Outputs and gradients of sum(out * r) for random r."""
    rng = np.random.default_rng(seed)
    left, right = (rng.standard_normal((B, D)).astype(np.float32)
                   for _ in range(2))
    r = rng.standard_normal((B, out_dim)).astype(np.float32)

    def jloss(params, a, b):
        out = jax_module.apply({"params": params}, a, b)
        return jnp.sum(out * r), out

    (_, want), (gp, ga, gb) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            tree, jnp.asarray(left), jnp.asarray(right))
    from_jax_params(tree, module)
    tl = torch.as_tensor(left).requires_grad_()
    tr = torch.as_tensor(right).requires_grad_()
    got = module(tl, tr)
    (got * torch.as_tensor(r)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    grads = _flat(named_to_tree({n: p.grad for n, p in module.named_parameters()}))
    grads.update(left=tl.grad.numpy(), right=tr.grad.numpy())
    _assert_grads(grads, {**_flat(gp), "left": ga, "right": gb})


@pytest.mark.parametrize("sim_method,out_dim,hidden", [
    ("hole", 1, (8,)), ("ntn", 1, (16,)), ("ntn", 3, ()),
    ("dist-mult", 2, (16,)), ("mlp", 1, (8, 4)), ("symmlp", 2, (8,)),
    ("cosine", 1, ()), ("cosine", 2, ())])
def test_head_matches_jax(sim_method, out_dim, hidden):
    head = make_head(sim_method, D, out_dim, hidden)
    tree = init_module_params(head, seed=len(sim_method) + out_dim)
    kwargs = {"out_dim": out_dim}
    if sim_method != "cosine":
        kwargs["hidden_dims"] = hidden
    jax_head = JAX_HEADS[sim_method](**kwargs)
    flax_tree = jax_head.init(jax.random.PRNGKey(0), jnp.zeros((B, D)),
                              jnp.zeros((B, D))).get("params", {})
    assert {k: v.shape for k, v in _flat(tree).items()} == {
        k: v.shape for k, v in _flat(flax_tree).items()}
    _check(head, jax_head, tree, seed=out_dim, out_dim=out_dim)


def test_cosine_head_with_one_output_has_no_parameters():
    assert list(make_head("cosine", D, 1).parameters()) == []
    assert [n for n, _ in make_head("cosine", D, 2).named_parameters()] == [
        "out.weight", "out.bias"]


def test_bilinear_keeps_the_flax_layout_and_matches_jax():
    layer = Bilinear(D, D, 5)
    tree = init_module_params(layer, seed=1)
    assert _flat(tree)["W"].shape == (D, D, 5)
    assert _flat(tree)["V1/kernel"].shape == (D, 5)
    _check(layer, JaxBilinear(5), tree, seed=2, out_dim=5)


def test_unknown_head_is_refused():
    with pytest.raises(ValueError, match="unknown sim_method"):
        make_head("transe", D, 1)
