"""Process groups, device meshes and rank processes (port of
gcnbmp_tpu/parallel/mesh.py:12-41).

One process drives one device: NCCL between CUDA devices, gloo between
CPU processes (the CPU tests).  ``init_distributed`` joins or sets up the
default process group; ``make_mesh`` lays a ``DeviceMesh`` over it with
the JAX package's ``("data", "model")`` axes, ``graph_mesh`` with its
``("graph",)`` axis.  ``launch`` starts one process per rank and joins
them within a time limit.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

def backend_for(device_type: str) -> str:
    """NCCL between CUDA devices, gloo between CPU processes."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` (modulo the visible cards)
    for a CUDA ``device``, else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the default process group, or set it up; returns (rank,
    world size).  A group set up already (by ``launch`` or the caller) is
    kept.  Without ``init_method``: torchrun's environment (``env://``)
    when it names a world size, else a group of this process alone
    (an in-memory store)."""
    if not dist.is_initialized():
        device = torch.device(device)
        store = None
        if init_method is None and "WORLD_SIZE" not in os.environ:
            store, world_size, rank = dist.HashStore(), 1, 0
        dist.init_process_group(backend or backend_for(device.type),
                                init_method=init_method, store=store,
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank)
        if device.type == "cuda":
            torch.cuda.set_device(rank_device(device))
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Tuple[str, str] = ("data", "model"),
              device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the process group's ranks,
    ``model_parallel`` consecutive ranks per model group, the rest data
    parallel.  The mesh spans the whole group: ``n_devices`` must equal
    its world size when given."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"the mesh spans the process group's {n} ranks, "
                         f"not {n_devices}")
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def graph_mesh(device_type: str = "cuda"):
    """The one-axis ``("graph",)`` mesh of graph-sharded training over
    every rank of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("graph",))


def batch_sharding(mesh, axis: str = "data") -> list:
    """DTensor placements that split the leading (batch) dim over
    ``axis`` and replicate over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def _rank_main(rank: int, fn: Callable, nprocs: int, init_method: str,
               device_type: str, backend: Optional[str], args: Sequence):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank))
    if device_type == "cpu":
        torch.set_num_threads(1)
    init_distributed(device_type, init_method, nprocs, rank, backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: Sequence = (),
           device_type: str = "cpu", backend: Optional[str] = None,
           timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (spawned), each rank
    in the default process group over a file store (``backend_for
    (device_type)`` unless ``backend`` is given; rank r drives
    ``cuda:r`` modulo the visible cards), with torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` set.  ``fn`` must be importable by
    name.  Raises if a rank fails, or, after ``timeout`` seconds, stops
    every rank and raises TimeoutError."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="gcnbmp_pg_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, init_method, device_type, backend,
                              tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
