"""Multi-host bring-up and per-host feeding (port of
gcnbmp_tpu/parallel/multihost.py:26-87) over ``torch.distributed``.

One process drives one device, on however many hosts, so a process's
"host-local" rows are its own rank's block: ``initialize_multihost`` joins
the group from a coordinator address or from torchrun's environment,
``global_mesh`` lays the (data, model) mesh over every rank (model
groups of consecutive ranks, which torchrun places on one host), and the
batch helpers give each rank only its own rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gcnbmp_tpu_torch.parallel.mesh import (
    batch_sharding, init_distributed, make_mesh)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> None:
    """Join the job's process group: ``coordinator_address`` (``host:port``
    for TCP, or an ``init_method`` URL such as ``file:///shared/store``)
    with ``num_processes`` and this ``process_id``; without them, from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``)."""
    init_method = "env://"
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    init_distributed(device, init_method, num_processes, process_id)


def global_mesh(model_parallel: int = 1,
                axis_names: Sequence[str] = ("data", "model"),
                device_type: str = "cuda"):
    """The (data, model) mesh over every rank of the job."""
    return make_mesh(None, model_parallel, tuple(axis_names), device_type)


def host_local_to_global(local_batch: np.ndarray, mesh, axis: str = "data"):
    """The global batch as a ``DTensor`` sharded over ``axis`` (replicated
    over the mesh's other axes), from this rank's block of it (the twin
    of ``jax.make_array_from_process_local_data``)."""
    from torch.distributed.tensor import DTensor

    local = torch.as_tensor(np.asarray(local_batch))
    if mesh.device_type == "cuda":
        local = local.cuda()
    return DTensor.from_local(local, mesh, batch_sharding(mesh, axis))


def shard_packed_batch_multihost(coo, mesh, axis: str = "graph",
                                 device="cuda"):
    """This rank's wire and labels of a COO batch that every process
    builds alike (``edgeshard.shard_packed_coo_batch``): the rank
    partitions the global arrays and keeps only its own block.  The JAX
    function feeds dense batches; the port feeds the COO layout."""
    from gcnbmp_tpu_torch.parallel.edgeshard import shard_packed_coo_batch

    return shard_packed_coo_batch(coo, mesh, axis, device=device)
