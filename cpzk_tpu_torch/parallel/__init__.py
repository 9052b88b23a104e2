"""Multi-device parallelism: meshes, sharded batch verification and
proving, and the multi-process job (port of ``cpzk_tpu/parallel/``).

Proofs shard along the batch axis over an ordered list of devices
(:class:`~.mesh.Mesh`); each device runs its slice on its own CUDA stream
and only per-slice partial points cross devices or processes.

Re-exports resolve lazily, and importing this package initializes neither
CUDA nor a ``torch.distributed`` process group, so
:func:`multihost.initialize` can always run after ``import
cpzk_tpu_torch.parallel``.
"""

from . import multihost

__all__ = [
    "multihost",
    "Mesh",
    "batch_mesh",
    "make_sharded_combined_check",
    "make_sharded_msm",
    "make_sharded_msm_check",
    "make_sharded_prove",
    "make_sharded_verify_each",
    "resolve_lane_devices",
    "resolve_mesh_devices",
    "sharded_combined_check",
    "sharded_msm_check",
    "sharded_prove",
    "sharded_verify_each",
]

_MESH_NAMES = frozenset(__all__) - {"multihost"}


def __getattr__(name: str):
    if name in _MESH_NAMES:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
