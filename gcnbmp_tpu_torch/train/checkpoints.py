"""Checkpoint save and restore (port of gcnbmp_tpu/train/checkpoints.py),
and the loader of a trained run for serving.

A checkpoint is a directory holding

- ``params.npz``: the model's flax-layout param tree
  (``convert.to_jax_params``), which the predict CLI serves as it is;
- ``opt_state.npz``: Adam's count and moments in the same layout, under
  ``mu/...`` and ``nu/...``, and the trainer's ``step``, ``epoch``,
  ``best_val_loss`` and ``epochs_since_best``.

The JAX package writes orbax checkpoints, which need orbax to read; the
port writes and reads numpy files.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from gcnbmp_tpu_torch.convert import (
    _flax_path, flat_npz, from_jax_params, load_params_npz, named_to_tree,
    save_params_npz, to_jax_params)


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` (a ``train.loop.TrainState``) under directory
    ``path``."""
    os.makedirs(path, exist_ok=True)
    model, opt = state.model, state.optimizer
    save_params_npz(os.path.join(path, "params.npz"), to_jax_params(model))
    names = [n for n, _ in model.named_parameters()]
    arrays = {}
    for prefix, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for key, v in flat_npz(named_to_tree(dict(zip(names, moments)))).items():
            arrays[f"{prefix}/{key}"] = v
    np.savez(os.path.join(path, "opt_state.npz"), **arrays,
             count=np.int64(opt.count), step=np.int64(state.step),
             epoch=np.int64(state.epoch),
             best_val_loss=np.float64(state.best_val_loss),
             epochs_since_best=np.int64(state.epochs_since_best))


def _check_layout(what: str, got: Dict[str, np.ndarray],
                  want: Dict[str, tuple]) -> None:
    """Raise naming the first tensor of ``want`` (key -> shape) that
    ``got`` lacks or holds in another shape, or the first extra one."""
    for key, shape in want.items():
        if key not in got:
            raise ValueError(f"{what} lacks tensor {key!r} {shape} of the "
                             "model")
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{what}: tensor {key!r} has shape "
                             f"{tuple(got[key].shape)}, the model's is "
                             f"{shape}")
    for key in got:
        if key not in want:
            raise ValueError(f"{what} holds tensor {key!r}, which the model "
                             "lacks")


def restore_checkpoint(path: str, state):
    """Restore the checkpoint under ``path`` into ``state`` (a
    ``train.loop.TrainState`` whose model and optimizer are built): the
    model's parameters and every Adam moment are copied in place, bit
    for bit, and ``count``, ``step``, ``epoch``, ``best_val_loss`` and
    ``epochs_since_best`` are set.  A checkpoint whose tensors differ
    from the model's in key or shape is refused, naming the first that
    differs.  Returns ``state``."""
    model, opt = state.model, state.optimizer
    params_path = os.path.join(path, "params.npz")
    if not os.path.exists(params_path):
        raise FileNotFoundError(f"no checkpoint at {path!r}: {params_path} "
                                "does not exist")
    named = [n for n, _ in model.named_parameters()]
    layout = {k: v.shape for k, v in flat_npz(to_jax_params(model)).items()}
    tree = load_params_npz(params_path)
    _check_layout(params_path, flat_npz(tree), layout)
    with np.load(os.path.join(path, "opt_state.npz")) as z:
        opt_arrays = {k: z[k] for k in z.files}
    moments = {f"{prefix}/{k}": shape for prefix in ("mu", "nu")
               for k, shape in layout.items()}
    meta = ("count", "step", "epoch", "best_val_loss", "epochs_since_best")
    _check_layout(os.path.join(path, "opt_state.npz"),
                  {k: v for k, v in opt_arrays.items() if k not in meta},
                  moments)
    from_jax_params(tree, model)
    with torch.no_grad():
        for prefix, dst in (("mu", opt.mu), ("nu", opt.nu)):
            for name, buf in zip(named, dst):
                leaf = _flax_path(name)
                arr = opt_arrays[f"{prefix}/{'/'.join(leaf)}"]
                if leaf[-1] == "kernel":
                    arr = arr.T
                buf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    opt.count = int(opt_arrays["count"])
    state.step = int(opt_arrays["step"])
    state.epoch = int(opt_arrays["epoch"])
    state.best_val_loss = float(opt_arrays["best_val_loss"])
    state.epochs_since_best = int(opt_arrays["epochs_since_best"])
    return state


def served_predictor(config: dict, tree: dict):
    """The predictor of run config ``config`` (a ``config.json`` dict)
    holding the flax-layout weights ``tree``, in the layout the JAX CLIs
    score the run on: the packed one where ``_packed_eval_eligible``
    holds, else the padded one (a padded run, every GWM run).  Packed, it
    is built as serving builds it: MPNN's Set2Set table the JAX
    evaluator's 64 atoms wide, a co-attention model's atom table width
    left to the dataset, except ``lt``'s, which its weights fix (``W1``;
    the evaluator refuses a dataset that needs another).  Padded, ``lt``'s
    weights fix the pad size alike."""
    from gcnbmp_tpu_torch.eval.evaluate import _packed_eval_eligible

    lt_width = (tree["coattention"]["W1"].shape[0]
                if config.get("attn") == "lt" else None)
    if _packed_eval_eligible(config):
        from gcnbmp_tpu_torch.models.packed import (
            make_packed_predictor, model_kwargs_from_config)

        kwargs = model_kwargs_from_config(config)
        kwargs["coattn_n_max"] = lt_width
        return from_jax_params(tree, make_packed_predictor(**kwargs))
    return padded_predictor(config, tree)


def padded_predictor(config: dict, tree: dict):
    """The padded predictor of run config ``config`` holding ``tree``,
    whatever layout the run trained on (the two layouts' trees have the
    same names): what the JAX ``Trainer`` builds as ``trainer.predictor``
    for every compute path, and its evaluate CLI's saliency differentiates.
    ``lt``'s weights fix its pad size (``W1``)."""
    from gcnbmp_tpu_torch.models.predictor import (
        padded_kwargs_from_config, set_up_predictor)

    kwargs = padded_kwargs_from_config(config)
    kwargs["coattn_n_max"] = (tree["coattention"]["W1"].shape[0]
                              if config.get("attn") == "lt" else None)
    return from_jax_params(tree, set_up_predictor(**kwargs))


def load_run(run: str, checkpoint: str = "best", device="cuda"):
    """The served predictor of a trained run, in the layout the JAX CLIs
    score it on: reads ``<run>/config.json`` (a JAX run's format, as the
    train CLI writes it) and ``<run>/<checkpoint>/params.npz`` into
    ``served_predictor``.  No
    optimizer state is read.  Returns (the config dict, the predictor on
    ``device``)."""
    with open(os.path.join(run, "config.json")) as f:
        config = json.load(f)
    path = os.path.join(run, checkpoint, "params.npz")
    if not os.path.exists(path):
        # a run trained without a val set writes no best
        held = sorted(d for d in os.listdir(run)
                      if os.path.exists(os.path.join(run, d, "params.npz")))
        raise FileNotFoundError(
            f"no checkpoint {checkpoint!r} in run {run!r} ({path} does not "
            f"exist); the run holds: {', '.join(held) or 'none'}")
    tree = load_params_npz(path)
    return config, served_predictor(config, tree).to(torch.device(device))
