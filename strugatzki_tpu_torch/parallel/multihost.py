"""Multi-process groups on :mod:`torch.distributed`.

Port of ``strugatzki_tpu/parallel/multihost.py``.  Scaling the files axis
across processes (hosts) needs a process group and a mesh whose shards know
their owner: every process contributes its local devices to
:func:`global_files_mesh`, stages the rows of its own shards, runs a
sharded step on them (:func:`~.sweep.sharded_sweep_step`) and gathers the
small per-file results with :func:`process_allgather`.  The backend is gloo
for CPU devices and NCCL for CUDA devices.

Tested with two local processes joining a gloo group over localhost (4 CPU
shards each → an 8-shard global mesh, 4 + 2 → an uneven 6-shard one):
tests/test_torch_multihost.py.  A ``FeatureDatabase`` whose mesh spans
processes is not supported; the JAX package's tests do not stage one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["initialize", "global_files_mesh", "process_allgather"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               **kwargs) -> None:
    """Join the process group (no-op when the run is a single process).

    Arguments default to the ``JAX_COORDINATOR_ADDRESS`` (``host:port`` of
    process 0) / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment
    variables the JAX package reads.  ``device`` picks the backend: gloo
    for the CPU, NCCL for CUDA.  ``initialization_timeout`` (seconds)
    becomes the group's ``timeout``: a worker that never arrives (crashed
    before joining, wrong address) surfaces as a clean error on every
    waiting process within it.  Other keyword arguments pass through to
    :func:`torch.distributed.init_process_group`.  (The JAX package also
    auto-detects Cloud TPU pods; nothing here does.)"""
    import torch.distributed as dist

    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None
                or "JAX_COORDINATOR_ADDRESS" in os.environ
                or "JAX_NUM_PROCESSES" in os.environ)
    if not explicit:
        return                      # plain single-process run
    if num_processes is None:
        env_np = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if num_processes == 1 and coordinator_address is None:
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "process count and this process's id")
    timeout = kwargs.pop("initialization_timeout", None)
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def global_files_mesh(local_devices: Optional[Sequence] = None):
    """A ``files`` mesh over every device of the job: each process
    contributes ``local_devices`` (default: its CUDA devices; repeats allowed
    as in :func:`~.sweep.make_files_mesh`), the counts may differ between
    processes, and the shards are ordered by process, then by local device.
    Outside a process group it is this process's mesh."""
    import torch.distributed as dist

    from .sweep import FilesMesh, _local_devices, make_files_mesh

    local = make_files_mesh(_local_devices() if local_devices is None
                            else local_devices)
    if not dist.is_initialized():
        return local
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local.devices])
    devices, owners = [], []
    rank = dist.get_rank()
    for r, ns in enumerate(names):
        devices += (list(local.devices) if r == rank
                    else [torch.device(n) for n in ns])
        owners += [r] * len(ns)
    return FilesMesh(tuple(devices), tuple(owners), rank)


def process_allgather(x) -> np.ndarray:
    """This process's rows (an array or a tensor) → every process's rows,
    concatenated along the leading axis in process order (the counterpart
    of ``multihost_utils.process_allgather(x, tiled=True)``).  Outside a
    process group it is ``x`` as a host array."""
    import torch.distributed as dist

    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    if not dist.is_initialized():
        return x
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, x)
    return np.concatenate(parts)
