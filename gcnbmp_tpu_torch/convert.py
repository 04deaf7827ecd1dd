"""Weights carried between the JAX package and the port.

A *tree* here is the flax param tree of the JAX package's
``PackedPairPredictorCOOCompact``, or of its padded ``PairPredictor``
and ``GWMPairPredictor`` (the same names, plus ``encoder2`` when
``siamese=False``, ``encoder/readout_{l}`` per layer with
``concat_hidden``, ``encoder/readout_agg`` with a layer aggregator), as
nested dicts of numpy arrays: for
GGNN ``encoder/embed/embedding``, ``encoder/update_{l}/message/dense/
{kernel,bias}``, ``encoder/gru/{W_z,U_z,W_r,U_r,W,U}/{kernel,bias}``,
``encoder/readout_0/{i,j}/dense/*``; for MPNN ``encoder/message_{l}/
{nn1,nn2}/*``, ``encoder/gru_{l}/...``, ``encoder/readout_0/set2set/lstm/
{ii,if,ig,io}/kernel`` and ``{hi,hf,hg,ho}/{kernel,bias}``,
``encoder/readout_0/{linear1,linear2}/*``; RelGCN's ``encoder/conv_{l}/
{self,edge}/dense/kernel``..., GIN's ``encoder/update_{l}/linear_g{1,2}``,
NFP's ``encoder/update_{l}/linear_d{d}`` and ``encoder/readout_{l}/
output_weight``, a layer aggregator's ``encoder/layer_aggregator/
{rnn_fwd,rnn_bwd,attn_dense}/...``, GWM's ``encoder/embed_super``,
``encoder/pre_update_{l}``, ``encoder/gwm_{l}/{super_query,...}``,
``encoder/gru_local``, ``encoder/gru_super`` and
``encoder/linear_for_concat_super``; the research options of GGNN:
``encoder/attention_{l}/{linear_transform,neural_network}/kernel``,
``encoder/update_{l}/output/*`` (the edge network),
``encoder/readout_{l}/{attention_w1,attention_w2,attention_v}`` with
``lstm_block/{input,forget,cell,output}_gate`` and ``ff_output``
(set2vec), and the context BiLSTM's two cells, which flax names
``encoder/OptimizedLSTMCell_0`` and ``_1`` (the ``nn.RNN`` wrappers hold
no parameters); GGNN-dev's ``encoder/fuse_{z,r,f}``, ``gate_{l}`` and
``self_loop_{l}/dense``; the research predictor's ``s_lstm_{1,2}`` and
``i_lstm``; the head's ``head/mlp/out/*``,
``head/bilinear/{W,V1/kernel,V2/kernel,b}`` (NTN), ``head/W_diag``...;
and a co-attention model's ``coattention/...`` (``W_0``, ``energy/W``,
``j/dense/*``...); the ``FixedEmbeddingPredictor`` tree is ``head/...``
alone, the GAE's ``encoder/{gc1,gc2}/kernel`` and ``relation_diag``.  The port's modules use the same names, so a flax
path maps to a torch name by joining it with dots; flax ``kernel``
(in, out) becomes the transposed ``nn.Linear.weight``, and every other
leaf keeps its flax layout.

Checkpoints travel as a flat ``.npz`` keyed by ``/``-joined paths in the
flax layout; ``to_jax_params`` takes a trained model back to that tree.
``train.checkpoints`` saves and restores the port's checkpoints in this
form; the JAX package's orbax checkpoints need orbax, which the port
does not read.
"""

from __future__ import annotations

import re
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
        # np.array keeps 0-d leaves 0-d (ascontiguousarray makes them 1-d)
        state[_torch_name(path)] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
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
        flat[path] = np.array(arr.T if path[-1] == "kernel" else arr,
                              order="C")
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


# the hidden kernels (recurrent_kernel_init) of flax.linen's
# OptimizedLSTMCell and GRUCell
_ORTHOGONAL = {"hi", "hf", "hg", "ho", "hr", "hz", "hn"}
# raw (non-Dense) leaves by their flax initializer: lecun-normal
# (Bilinear, PairBilinear, the para gates, DistMult), glorot-normal (lt's
# position projections), glorot-uniform (Set2Vec's attention), he-normal
# (BiMPM's perspectives), zeros (their biases)
_LECUN = re.compile(r"(W|V1|V2)(_\d+)?|W_diag")
_GLOROT = re.compile(r"W[12]")
_GLOROT_UNIFORM = re.compile(r"attention_(w1|w2|v)")
_HE = re.compile(r"\w+_W")
_ZEROS = re.compile(r"b(_\d+)?")


def _fans(shape) -> Tuple[int, int]:
    """flax's fan-in and fan-out: in_axis=-2, out_axis=-1, the other axes
    a receptive field."""
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def _truncated_normal(rng: np.random.Generator, shape, variance: float):
    """flax's variance_scaling with a truncated normal: a unit normal
    truncated to [-2, 2], scaled to ``variance``."""
    z = rng.standard_normal(shape)
    while (bad := np.abs(z) > 2.0).any():
        z[bad] = rng.standard_normal(int(bad.sum()))
    return z * (np.sqrt(variance) / _TRUNC_STD)


def init_params(cfg: dict, seed: int, padded: bool = False) -> dict:
    """Seeded numpy weights, in the flax layout, for the predictor that
    ``models.packed.make_packed_predictor(**cfg)`` builds, or with
    ``padded`` the padded one of ``models.predictor.set_up_predictor
    (**cfg)``.  Drawn from the flax initializers' distributions:
    lecun-normal kernels and raw bilinear weights, orthogonal LSTM and
    GRU hidden kernels, glorot-normal ``lt`` projections, glorot-uniform
    Set2Vec attention weights, he-normal BiMPM perspectives, zero biases, Normal(1.0) atom embedding.  Load with
    ``from_jax_params``."""
    if padded:
        from gcnbmp_tpu_torch.models.predictor import set_up_predictor as make
    else:
        from gcnbmp_tpu_torch.models.packed import (
            make_packed_predictor as make)

    return init_module_params(make(**cfg, device="meta"), seed)


def init_module_params(module: nn.Module, seed: int) -> dict:
    """``init_params`` for any of the port's modules (built on the meta
    device will do): its flax-layout tree, drawn leaf by leaf."""
    shapes = module.state_dict()
    rng = np.random.default_rng(seed)
    flat = {}
    for name, t in shapes.items():
        path = _flax_path(name)
        leaf = path[-1]
        shape = tuple(t.shape)
        if leaf == "kernel" and path[-2] in _ORTHOGONAL:
            arr = _orthogonal(rng, shape[1], shape[0])
        elif leaf == "kernel":
            fan_in, fan_out = shape[1], shape[0]
            arr = _truncated_normal(rng, (fan_in, fan_out), 1.0 / fan_in)
        elif leaf == "embedding":
            arr = rng.standard_normal(shape)
        elif leaf == "bias" or _ZEROS.fullmatch(leaf):
            arr = np.zeros(shape)
        elif _LECUN.fullmatch(leaf):
            arr = _truncated_normal(rng, shape, 1.0 / _fans(shape)[0])
        elif _GLOROT.fullmatch(leaf):
            arr = _truncated_normal(rng, shape, 2.0 / sum(_fans(shape)))
        elif _GLOROT_UNIFORM.fullmatch(leaf):
            limit = np.sqrt(6.0 / sum(_fans(shape)))
            arr = rng.uniform(-limit, limit, shape)
        elif _HE.fullmatch(leaf):
            arr = _truncated_normal(rng, shape, 2.0 / _fans(shape)[0])
        else:
            raise ValueError(f"no initializer for parameter {name!r}")
        flat[path] = arr.astype(np.float32)
    return _unflatten(flat)
