"""The port's twin of the JAX package's ``__graft_entry__.entry()``
(__graft_entry__.py:14-55): the padded flagship pair predictor (GGNN,
8 untied layers, H = D = 32, HolE head, one logit) with seeded weights,
and its example batch (B = 8, N = 32, from a seeded numpy generator).

    from gcnbmp_tpu_torch import entry
    forward, args = entry.entry()          # on the card
    logits = forward(*args)                # (8, 1)

``forward`` is the predictor itself (an ``nn.Module`` in eval mode,
deterministic), so the caller can load other weights into it
(``convert.from_jax_params``).

    entry.dryrun_multichip(4)                 # four cards, NCCL
    entry.dryrun_multichip(4, device="cpu")   # four CPU processes, gloo

is the twin of ``__graft_entry__.dryrun_multichip`` (:58-116): one rank
per device, one data- plus tensor-parallel step of the padded flagship
(``parallel.dp``), then one graph-sharded step over every rank
(``parallel.edgeshard``).
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0


def _example_batch(batch=8, n_atoms=32, seed=0):
    """atoms (B, N) int32, adj (B, 4, N, N) f32 (a path with random bond
    types), mask (B, N) of ones, labels (B,): the JAX module's draws."""
    rng = np.random.default_rng(seed)
    atoms = rng.integers(1, 54, size=(batch, n_atoms)).astype(np.int32)
    adj = np.zeros((batch, 4, n_atoms, n_atoms), dtype=np.float32)
    for b in range(batch):
        for i in range(n_atoms - 1):
            e = int(rng.integers(0, 4))
            adj[b, e, i, i + 1] = adj[b, e, i + 1, i] = 1.0
    mask = np.ones((batch, n_atoms), dtype=np.float32)
    labels = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    return atoms, adj, mask, labels


FLAGSHIP = dict(method="ggnn", fp_hidden_dim=32, fp_out_dim=32,
                conv_layers=8, weight_tying=False, sim_method="hole",
                class_num=1)


def entry(device="cuda"):
    """(forward, args) on ``device``: the flagship predictor and
    (atoms, adj, atoms, adj, mask, mask) of the example batch."""
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.models.predictor import set_up_predictor

    device = torch.device(device)
    model = from_jax_params(init_params(FLAGSHIP, SEED, padded=True),
                            set_up_predictor(**FLAGSHIP)).to(device).eval()
    atoms, adj, mask, _ = _example_batch()
    a, j, m = (torch.as_tensor(x).to(device) for x in (atoms, adj, mask))
    return model, (a, j, a, j, m, m)


def _dryrun_rank(device: str) -> None:
    """One rank of ``dryrun_multichip`` (its process group is set up)."""
    import torch.distributed as dist

    from gcnbmp_tpu_torch.chem import GGNNFeaturizer, mol_from_smiles
    from gcnbmp_tpu_torch.convert import from_jax_params, init_params
    from gcnbmp_tpu_torch.data.dataset import PairDataset
    from gcnbmp_tpu_torch.data.packing import pack_pair_dataset_coo
    from gcnbmp_tpu_torch.models.packed import make_packed_predictor
    from gcnbmp_tpu_torch.models.predictor import set_up_predictor
    from gcnbmp_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, shard_params)
    from gcnbmp_tpu_torch.parallel.edgeshard import (
        make_edgeshard_coo_train_step, shard_packed_coo_batch)
    from gcnbmp_tpu_torch.parallel.mesh import graph_mesh, rank_device
    from gcnbmp_tpu_torch.train.config import TrainConfig
    from gcnbmp_tpu_torch.train.loop import ChainedAdam, build_optimizer

    n, rank = dist.get_world_size(), dist.get_rank()
    dev = rank_device(device)
    mesh = make_mesh(n, model_parallel=2 if n % 2 == 0 else 1,
                     device_type=dev.type)
    model = shard_params(
        from_jax_params(init_params(FLAGSHIP, SEED, padded=True),
                        set_up_predictor(**FLAGSHIP)).to(dev), mesh)
    optimizer, _ = build_optimizer(TrainConfig(), 100,
                                   list(model.parameters()))
    data = mesh["data"].size()
    batch = -(-max(8, n) // data) * data
    atoms, adj, mask, labels = _example_batch(batch=batch, n_atoms=16)
    a, j, m, y = (torch.as_tensor(x).to(dev)
                  for x in (atoms, adj, mask, labels))
    loss = float(make_sharded_train_step(model, optimizer, mesh)(
        a, j, a, j, m, m, y))
    if not np.isfinite(loss):
        raise FloatingPointError(f"data + tensor parallel loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip: {n} ranks, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, loss "
              f"{loss:.4f}", flush=True)

    rng = np.random.default_rng(0)
    feat = GGNNFeaturizer()
    ds = PairDataset()
    smis = ["CCO", "c1ccccc1", "CC(=O)O", "C=O", "CCN", "COC"]
    n_pairs = max(8, n)
    for _ in range(n_pairs):
        ds.append(feat(mol_from_smiles(smis[int(rng.integers(len(smis)))])),
                  feat(mol_from_smiles(smis[int(rng.integers(len(smis)))])),
                  np.float32(rng.integers(0, 2)))
    coo = pack_pair_dataset_coo(ds, list(range(n_pairs)), num_tiles=n)
    packed = from_jax_params(init_params(FLAGSHIP, SEED),
                             make_packed_predictor(**FLAGSHIP)).to(dev)
    gmesh = graph_mesh(dev.type)
    step = make_edgeshard_coo_train_step(
        packed, ChainedAdam(list(packed.parameters()), lambda count: 1e-3),
        gmesh)
    loss = float(step(*shard_packed_coo_batch(coo, gmesh, device=dev)))
    if not np.isfinite(loss):
        raise FloatingPointError(f"edgeshard loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip: edgeshard over {n}-rank graph axis, loss "
              f"{loss:.4f}", flush=True)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> None:
    """One rank per device (``n_devices`` cards over NCCL, or CPU
    processes over gloo): a data- plus tensor-parallel step of the padded
    flagship over a (data, model) mesh (model axis 2 when ``n_devices``
    is even), then a graph-sharded step of the packed flagship over every
    rank; each loss must be finite.  Raises if a rank fails."""
    from gcnbmp_tpu_torch.parallel.mesh import launch

    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise ValueError(f"{n_devices} ranks need {n_devices} cards (NCCL "
                         f"takes one rank per card); "
                         f"{torch.cuda.device_count()} visible")
    launch(_dryrun_rank, n_devices, (device.type,), device_type=device.type,
           timeout=timeout)
