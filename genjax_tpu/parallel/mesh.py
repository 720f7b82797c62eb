"""Device-mesh construction and batch sharding helpers.

The framework's layout convention makes sharding trivial: every trace,
choice map, and particle collection is a pytree whose leaves carry the
batch (chain/particle) axis in front. Sharding a computation is therefore
one ``NamedSharding(mesh, P("batch"))`` on the leading axis — XLA inserts
collectives for any cross-batch reduction (means, logsumexp) on its
own, and ``shard_map`` is reserved for algorithms that need explicit
per-shard logic (collective resampling).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.tree_util as jtu
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_map_compat(f, *, mesh: Mesh, in_specs, out_specs, check: bool = False):
    """``jax.shard_map`` across jax versions: the import moved out of
    ``jax.experimental`` and the replication-check kwarg was renamed
    ``check_rep`` → ``check_vma``. One shim for every caller (the sharded
    SMC/MCMC drivers, tests, and the scaling harness)."""
    import inspect

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    kw_name = (
        "check_vma"
        if "check_vma" in inspect.signature(shard_map).parameters
        else "check_rep"
    )
    return shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        **{kw_name: check},
    )


def make_mesh(
    n_devices: int | None = None, axis: str = "batch", devices=None
) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all available) with a single
    named axis for the chain/particle batch dimension.

    >>> from genjax_tpu.parallel import make_mesh
    >>> mesh = make_mesh()
    >>> mesh.axis_names
    ('batch',)
    >>> mesh.devices.size >= 1
    True
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"make_mesh({n_devices}) but only {len(devices)} device(s) "
                    f"are available on platform "
                    f"'{devices[0].platform}'. For a virtual CPU mesh, set "
                    f"jax.config.update('jax_num_cpu_devices', n) (and "
                    f"'jax_platforms'='cpu') before the first JAX operation."
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_hier_mesh(
    n_islands: int,
    n_shards: int | None = None,
    axes: tuple[str, str] = ("island", "batch"),
    devices=None,
) -> Mesh:
    """A 2-D hierarchical mesh: ``axes[0]`` (slow interconnect — DCN
    across pod slices) × ``axes[1]`` (fast — ICI within a slice), for the
    island particle filter and any other rare-exchange algorithm.

    On real multi-slice hardware, pass ``devices`` from
    ``jax.experimental.mesh_utils.create_hybrid_device_mesh`` so the
    island axis actually falls on the DCN boundary; by default the
    available devices are reshaped in order, which is correct for a
    single slice and for the CPU test mesh.

    >>> import jax
    >>> from genjax_tpu.parallel import make_hier_mesh
    >>> mesh = make_hier_mesh(2, len(jax.devices()) // 2) if len(
    ...     jax.devices()) >= 2 else make_hier_mesh(1, 1)
    >>> mesh.axis_names
    ('island', 'batch')
    """
    if devices is None:
        devices = jax.devices()
    if n_shards is None:
        if len(devices) % n_islands:
            raise ValueError(
                f"{len(devices)} devices do not split into {n_islands} islands"
            )
        n_shards = len(devices) // n_islands
    need = n_islands * n_shards
    if need > len(devices):
        raise ValueError(
            f"make_hier_mesh({n_islands}, {n_shards}) needs {need} devices "
            f"but only {len(devices)} are available"
        )
    grid = np.asarray(devices[:need]).reshape(n_islands, n_shards)
    return Mesh(grid, axes)


def initialize_distributed(**kwargs) -> None:
    """Initialize the multi-host JAX runtime (call once per process before
    building meshes on a pod slice). Thin passthrough to
    ``jax.distributed.initialize`` so framework users have one entry
    point."""
    jax.distributed.initialize(**kwargs)


def host_local_mesh(axis: str = "batch") -> Mesh:
    """Mesh over this process's addressable devices only."""
    return Mesh(np.asarray(jax.local_devices()), (axis,))


def shard_batch(tree: Any, mesh: Mesh, axis: str = "batch") -> Any:
    """Place ``tree`` with its leading axis sharded over ``mesh``'s ``axis``.
    Scalar leaves (no leading batch dim) are replicated."""
    batch_sharding = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    def place(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1:
            return jax.device_put(leaf, batch_sharding)
        return jax.device_put(leaf, replicated)

    return jtu.tree_map(place, tree)


def batch_spec(axis: str = "batch") -> P:
    return P(axis)
