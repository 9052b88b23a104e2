"""Multi-process scale-out over ``torch.distributed``: the port of
``cpzk_tpu/parallel/multihost.py``.

Every process runs the same program on the same (replicated) inputs.
:func:`initialize` forms a **gloo** process group, and
:func:`global_batch_mesh` returns a :class:`~.mesh.Mesh` over every
rank's devices.  Each rank runs the slices of the devices it owns; only
the small per-slice results (partial points, row bits, commitment bytes)
cross between processes, all-gathered on the host over gloo, so every
rank reaches the same verdict.  Gloo, not NCCL: it needs no card per rank
(two ranks may share one GPU) and the gathered objects are a few hundred
bytes per slice.

Typical deployment (one process per host)::

    from cpzk_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="10.0.0.1:8476",
                         num_processes=4, process_id=HOST_INDEX)
    mesh = multihost.global_batch_mesh()
    backend = TorchBackend(mesh_devices=0, devices=mesh)

Single-process jobs may call these unconditionally: ``initialize`` is a
no-op when nothing configures a job.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger("cpzk_tpu_torch.parallel.multihost")

_initialized = False
_global_mesh = None


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the distributed job; a no-op for single-process development.

    Arguments default from ``CPZK_COORDINATOR`` (``host:port`` of rank 0's
    rendezvous), ``CPZK_NUM_PROCESSES`` and ``CPZK_PROCESS_ID``.  The job
    is formed when ANY of those (or ``CPZK_MULTIHOST=1``) is present; all
    three values are then required (nothing here detects a cluster).  With
    no configuration at all this is a no-op.  Repeat calls after a real
    join are rejected loudly."""
    global _initialized
    coordinator = coordinator or os.environ.get("CPZK_COORDINATOR")
    if num_processes is None and (v := os.environ.get("CPZK_NUM_PROCESSES")):
        num_processes = int(v)
    if process_id is None and (v := os.environ.get("CPZK_PROCESS_ID")):
        process_id = int(v)
    explicit = (
        coordinator is not None
        or num_processes is not None
        or process_id is not None
        or os.environ.get("CPZK_MULTIHOST", "") in ("1", "true", "on")
    )
    if _initialized:
        if explicit:
            raise RuntimeError(
                "multihost.initialize called again after the job was formed; "
                "configure the coordinator once, before any device use"
            )
        return
    if not explicit:
        return  # single-process development: nothing to form, not latched
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "multihost.initialize needs the coordinator address, the process "
            "count and this process's id (CPZK_COORDINATOR, "
            "CPZK_NUM_PROCESSES, CPZK_PROCESS_ID)"
        )
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )
    _initialized = True
    log.info("joined distributed job: process %d/%d over gloo at %s",
             process_id, num_processes, coordinator)


def global_batch_mesh(local_devices=None):
    """A mesh over every device in the job, rank by rank in rank order.

    ``local_devices`` are this process's devices (an explicit list, which
    may repeat a device); by default every local CUDA device.  In a job
    this is a collective: every rank calls it.  The default mesh is made
    once per job."""
    global _global_mesh
    from .mesh import Mesh

    if local_devices is None and _global_mesh is not None:
        return _global_mesh
    local = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if local_devices is None else [torch.device(d) for d in local_devices])
    if not local:
        raise RuntimeError(
            "global_batch_mesh: no local CUDA device (pass local_devices)")
    rank, world = process_info()
    if world == 1:
        mesh = Mesh(local)
    else:
        import torch.distributed as dist

        per_rank: list = [None] * world
        dist.all_gather_object(per_rank, [str(d) for d in local])
        devices, owners = [], []
        for r, devs in enumerate(per_rank):
            # another rank's devices are named for the record only: a
            # rank touches its own slices' devices, never another's
            devices += [d if r == rank else "cpu" for d in devs]
            owners += [r] * len(devs)
        mesh = Mesh(devices, owners, rank)
    if local_devices is None:
        _global_mesh = mesh
    return mesh


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process in the job; (0, 1) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the job (destroy the process group); a no-op outside one."""
    global _initialized, _global_mesh
    import torch.distributed as dist

    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _global_mesh = None
