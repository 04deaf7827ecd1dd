"""Weights carried between the JAX package and the port.

A *tree* here is the flax param tree of the JAX package's
``PackedPairPredictorCOOCompact`` as nested dicts of numpy arrays: for
GGNN ``encoder/embed/embedding``, ``encoder/update_{l}/message/dense/
{kernel,bias}``, ``encoder/gru/{W_z,U_z,W_r,U_r,W,U}/{kernel,bias}``,
``encoder/readout_0/{i,j}/dense/*``; for MPNN ``encoder/message_{l}/
{nn1,nn2}/*``, ``encoder/gru_{l}/...``, ``encoder/readout_0/set2set/lstm/
{ii,if,ig,io}/kernel`` and ``{hi,hf,hg,ho}/{kernel,bias}``,
``encoder/readout_0/{linear1,linear2}/*``; and ``head/mlp/out/*``.  The port's
modules use the same names, so a flax path maps to a torch name by
joining it with dots; flax ``kernel`` (in, out) becomes the transposed
``nn.Linear.weight``.

Checkpoints travel as a flat ``.npz`` keyed by ``/``-joined paths in the
flax layout; ``to_jax_params`` takes a trained model back to that tree.
Reading the JAX package's orbax checkpoints waits for the checkpoint
restore (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

# flax's lecun_normal: truncated normal on [-2, 2] with variance 1/fan_in;
# this constant is the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _torch_name(path: Tuple[str, ...]) -> str:
    leaf = "weight" if path[-1] == "kernel" else path[-1]
    return ".".join(path[:-1] + (leaf,))


def _flax_path(name: str) -> Tuple[str, ...]:
    parts = tuple(name.split("."))
    return parts[:-1] + ("kernel",) if parts[-1] == "weight" else parts


def from_jax_params(tree: dict, model: nn.Module) -> nn.Module:
    """Load a flax param tree into the port's ``model`` (strict: every
    parameter must be present, with its shape); returns ``model``."""
    state = {}
    for path, arr in _flatten(tree):
        if path[-1] == "kernel":
            arr = arr.T
        state[_torch_name(path)] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32))
    model.load_state_dict(state, strict=True)
    return model


def to_jax_params(model: nn.Module) -> dict:
    """The flax param tree (numpy, f32) of the port's ``model``: the
    inverse of ``from_jax_params``."""
    return named_to_tree({name: p for name, p in model.named_parameters()})


def named_to_tree(named: Dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by torch parameter name -> a flax-layout tree of
    numpy arrays (``nn.Linear`` weights transposed back to kernels)."""
    flat = {}
    for name, t in named.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        path = _flax_path(name)
        flat[path] = np.ascontiguousarray(arr.T if path[-1] == "kernel" else arr)
    return _unflatten(flat)


def flat_npz(tree: dict) -> Dict[str, np.ndarray]:
    """A tree as the ``/``-joined keys of its ``.npz`` form."""
    return {"/".join(p): v for p, v in _flatten(tree)}


def save_params_npz(path: str, tree: dict) -> None:
    np.savez(path, **flat_npz(tree))


def load_params_npz(path: str) -> dict:
    with np.load(path) as z:
        return _unflatten({tuple(k.split("/")): z[k] for k in z.files})


def _orthogonal(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """flax's ``initializers.orthogonal()`` for a (rows, cols) kernel: the
    Q of a Gaussian matrix's QR, signs fixed by R's diagonal."""
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return q.T if rows < cols else q


# flax.linen.OptimizedLSTMCell's hidden kernels (recurrent_kernel_init)
_ORTHOGONAL = {"hi", "hf", "hg", "ho"}


def init_params(cfg: dict, seed: int) -> dict:
    """Seeded numpy weights, in the flax layout, for the predictor that
    ``models.packed.make_packed_predictor(**cfg)`` builds.  Drawn from the
    flax initializers' distributions: lecun-normal kernels, orthogonal
    LSTM hidden kernels, zero biases, Normal(1.0) atom embedding.  Load
    with ``from_jax_params``."""
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor

    shapes = make_packed_predictor(**cfg, device="meta").state_dict()
    rng = np.random.default_rng(seed)
    flat = {}
    for name, t in shapes.items():
        path = _flax_path(name)
        if path[-1] == "kernel" and path[-2] in _ORTHOGONAL:
            arr = _orthogonal(rng, t.shape[1], t.shape[0])
        elif path[-1] == "kernel":
            fan_in, fan_out = t.shape[1], t.shape[0]
            z = rng.standard_normal((fan_in, fan_out))
            while (bad := np.abs(z) > 2.0).any():
                z[bad] = rng.standard_normal(int(bad.sum()))
            arr = z * (np.sqrt(1.0 / fan_in) / _TRUNC_STD)
        elif path[-1] == "embedding":
            arr = rng.standard_normal(tuple(t.shape))
        elif path[-1] == "bias":
            arr = np.zeros(tuple(t.shape))
        else:
            raise ValueError(f"no initializer for parameter {name!r}")
        flat[path] = arr.astype(np.float32)
    return _unflatten(flat)
