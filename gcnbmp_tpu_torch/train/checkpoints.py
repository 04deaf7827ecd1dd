"""Checkpoint save (port of ``save_checkpoint``, gcnbmp_tpu/train/checkpoints.py).

A checkpoint is a directory holding

- ``params.npz``: the model's flax-layout param tree
  (``convert.to_jax_params``), which the predict CLI serves as it is;
- ``opt_state.npz``: Adam's count and moments in the same layout, under
  ``mu/...`` and ``nu/...``, and the trainer's ``step``, ``epoch``,
  ``best_val_loss`` and ``epochs_since_best``.

The JAX package writes orbax checkpoints, which need orbax to read; the
port writes numpy files.  Restoring a checkpoint is ROADMAP queue 1,
item 6.
"""

from __future__ import annotations

import os

import numpy as np

from gcnbmp_tpu_torch.convert import (
    flat_npz, named_to_tree, save_params_npz, to_jax_params)


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
