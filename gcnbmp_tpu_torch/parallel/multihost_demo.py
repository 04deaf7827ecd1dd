"""A multi-process edgeshard step (the twin of
gcnbmp_tpu/parallel/multihost_demo.py), run as one process per rank:

    python -m gcnbmp_tpu_torch.parallel.multihost_demo <rank> <ranks> \\
        <coordinator> [cuda|cpu]

Each process joins the group (``initialize_multihost``; the coordinator
is ``host:port`` or a ``file://`` store), builds the same deterministic
toy dense packed batch, takes its own rows, runs ONE dense edgeshard
train step of the seeded GGNN + HolE predictor with Adam and prints

    MULTIHOST loss=<f> checksum=<f>

The step runs on the rank's card unless ``cpu`` is given.
``reference_loss_and_checksum()`` runs the same step in one process over
the whole batch (a group of one); the ranks must print its values.
"""

from __future__ import annotations

import sys

import numpy as np

_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "C=O", "CCN", "COC", "CCCC", "OCCO"]
_MODEL = dict(method="ggnn", fp_hidden_dim=16, fp_out_dim=16, conv_layers=4,
              weight_tying=True, sim_method="hole")


def demo_packed_batch(num_tiles: int = 8, n_pairs: int = 16, seed: int = 7):
    """The toy dense packed batch, the same in every process."""
    from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu_torch.data.dataset import PairDataset
    from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_batch

    rng = np.random.default_rng(seed)
    feat = GGNNFeaturizer()
    ds = PairDataset()
    for _ in range(n_pairs):
        ds.append(
            feat(mol_from_smiles(_SMILES[int(rng.integers(len(_SMILES)))])),
            feat(mol_from_smiles(_SMILES[int(rng.integers(len(_SMILES)))])),
            np.float32(rng.integers(0, 2)))
    return pack_pair_dataset_batch(ds, list(range(n_pairs)),
                                   num_tiles=num_tiles)


def run_step(device="cuda") -> tuple:
    """One edgeshard step over the group's ranks; returns (loss, the sum
    of |parameter| after the step)."""
    import torch

    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.parallel.edgeshard import make_edgeshard_train_step
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh, rank_device
    from gcnbmp_tpu_torch.parallel.multihost import (
        shard_packed_batch_multihost)
    from gcnbmp_tpu_torch.train.loop import ChainedAdam

    device = rank_device(device)
    model = from_jax_params(init_params(_MODEL, 0), make_packed_predictor(
        **_MODEL, compact=False)).to(device)
    opt = ChainedAdam(list(model.parameters()), lambda count: 1e-3)
    mesh = graph_mesh(device.type)
    step = make_edgeshard_train_step(model, opt, mesh)
    loss = step(*shard_packed_batch_multihost(demo_packed_batch(), mesh,
                                              device=device))
    checksum = sum(float(p.detach().abs().double().sum())
                   for p in model.parameters())
    return float(loss), checksum


def reference_loss_and_checksum(device="cuda") -> tuple:
    """The step in this process alone (a group of one, closed after)."""
    import torch.distributed as dist

    from gcnbmp_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device)
    try:
        return run_step(device)
    finally:
        dist.destroy_process_group()


def main(process_id: int, num_processes: int, coordinator: str,
         device: str = "cuda") -> None:
    import torch
    import torch.distributed as dist

    from gcnbmp_tpu_torch.parallel.multihost import initialize_multihost

    if device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(coordinator, num_processes, process_id, device)
    try:
        if dist.get_world_size() != num_processes:
            raise RuntimeError(f"joined a group of {dist.get_world_size()}")
        loss, checksum = run_step(device)
    finally:
        dist.destroy_process_group()
    print(f"MULTIHOST loss={loss:.8f} checksum={checksum:.6f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
