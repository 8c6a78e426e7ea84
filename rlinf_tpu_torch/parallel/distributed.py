"""Process-group bootstrap and batch rows across ranks.

Port of ``rlinf_tpu/parallel/distributed.py``. The JAX package initializes
``jax.distributed`` and builds global arrays from per-host shards; the port
initializes ``torch.distributed`` (one process per device) and represents
a row-sharded batch on a rank by the rank's own rows:

  initialize_distributed  the process group: env ``RANK``/``WORLD_SIZE``/
                          ``MASTER_ADDR``/``MASTER_PORT`` or an explicit
                          ``init_method`` (``file://`` or ``tcp://``); the
                          backend from the placement of ranks on devices
  shard_rows_for_process  the rows of a global batch this rank loads
  host_local_to_global    a rank's own rows, as the device tensors that
                          stand for the global batch on this rank
  global_device_put       the full host value -> this rank's block under a
                          spec (every rank holds the same host value)
  fetch_global            a rank's block -> the full value on every rank
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rlinf_tpu_torch.parallel.mesh import AxisNames as Ax, Mesh


def choose_backend(device_type: str, ranks_per_node: int, local_devices: int) -> str:
    """NCCL when each rank has a GPU of its own (the node's ranks fit its
    GPUs), gloo when ranks share a GPU or run on the CPU."""
    if device_type == "cuda" and local_devices >= ranks_per_node:
        return "nccl"
    return "gloo"


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str = "cuda",
    verbose: bool = True,
) -> Dict[str, object]:
    """Initialize the default process group; a world of one is a no-op.

    ``device="cuda"`` puts the rank on ``cuda:LOCAL_RANK`` when each rank
    has a card of its own and on ``cuda:0`` when the ranks share one. Both
    are decided per node: ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (env, as
    ``torchrun`` sets them) default to the rank and the world size, a
    single node. ``backend`` overrides the choice of :func:`choose_backend`. The choice
    is printed. A failed NCCL init raises: it never falls back to gloo.
    Returns ``process_info()`` with the device and backend.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    dev_type = torch.device(device).type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: initialize_distributed runs on the GPU by "
            "default; pass device='cpu' for a CPU world over gloo")
    n_local = torch.cuda.device_count() if dev_type == "cuda" else 0
    chosen = backend or choose_backend(dev_type, per_node, n_local)
    if chosen == "nccl" and (dev_type != "cuda" or n_local < 1):
        raise RuntimeError(
            "backend='nccl' needs a CUDA device for every rank; this process has "
            f"{n_local}")
    if dev_type == "cuda":
        dev = torch.device("cuda", local_rank if n_local >= per_node else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if world_size > 1 and not dist.is_initialized():
        if init_method is None and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        kw = {"device_id": dev} if chosen == "nccl" else {}
        dist.init_process_group(chosen, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    if verbose and rank == 0 and world_size > 1:
        print(f"[distributed] backend={chosen} world={world_size} device={dev.type}",
              flush=True)
    info = process_info()
    info.update(device=dev, backend=chosen if world_size > 1 else None)
    return info


def process_info() -> Dict[str, int]:
    """The JAX package's keys: this process's index and count, its local
    devices and the global device count (one device per rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return {
        "process_index": rank,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def _batch_block(n_rows: int, mesh: Optional[Mesh]) -> slice:
    if mesh is None:
        return slice(0, n_rows)
    n = mesh.size(Ax.BATCH)
    if n_rows % n != 0:
        raise ValueError(f"batch {n_rows} not divisible by the mesh's data x fsdp ({n})")
    per = n_rows // n
    i = mesh.axis_index(Ax.BATCH)
    return slice(i * per, (i + 1) * per)


def shard_rows_for_process(n_rows: int, mesh: Optional[Mesh] = None) -> slice:
    """The rows of the global batch this rank loads: its block along the
    mesh's batch axes (data x fsdp), or its block of the world's processes
    without a mesh."""
    if mesh is not None:
        return _batch_block(n_rows, mesh)
    pc = dist.get_world_size() if dist.is_initialized() else 1
    pi = dist.get_rank() if dist.is_initialized() else 0
    if n_rows % pc != 0:
        raise ValueError(f"batch {n_rows} not divisible by {pc} processes")
    per = n_rows // pc
    return slice(pi * per, (pi + 1) * per)


def host_local_to_global(local_batch: Dict[str, np.ndarray], mesh: Mesh,
                         spec=None, device="cuda") -> Dict[str, torch.Tensor]:
    """This rank's rows (numpy) as device tensors: on a rank the global
    batch is its own rows, so nothing moves between ranks."""
    del mesh, spec
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in local_batch.items()}


def global_device_put(x, mesh: Mesh, spec=(Ax.BATCH,), device="cuda") -> torch.Tensor:
    """The full value ``x`` (the same on every rank) -> this rank's block
    under ``spec`` (a tuple: per dim, an axis, a tuple of axes or None)."""
    from rlinf_tpu_torch.parallel.sharding import local_block

    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return local_block(t, spec, mesh).to(device)


def fetch_global(x: torch.Tensor, mesh: Mesh, spec: Sequence = (Ax.BATCH,)) -> torch.Tensor:
    """This rank's block under ``spec`` -> the full value, on every rank
    of the mesh (an all-gather along each sharded dim)."""
    from rlinf_tpu_torch.parallel.sharding import gather_block

    return gather_block(x, spec, mesh)
