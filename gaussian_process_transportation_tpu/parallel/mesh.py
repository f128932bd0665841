"""Device-mesh helpers.

The framework's parallel axes (SURVEY.md §2d — all *new* relative to the
single-process reference):

* ``ens``  — ensemble/chain axis: transport ensembles, NUTS chains,
             multi-restart hyperopt.  Pure data parallelism.
* ``data`` — within-problem axis: trajectory/Gram rows for large-N
             problems (sequence-parallel analog).

A 1-chip mesh is the degenerate case, so every code path is written
against a mesh and runs unchanged from 1 chip to a pod.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_ens: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_ens is None:
        n_ens = len(devices) // n_data
    use = devices[: n_ens * n_data]
    arr = np.asarray(use).reshape(n_ens, n_data)
    return Mesh(arr, ("ens", "data"))


def ensemble_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ensemble) axis over the 'ens' mesh axis."""
    return NamedSharding(mesh, P("ens"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def global_put(x, sharding: NamedSharding):
    """Place a host-replicated array under a (possibly multi-process)
    sharding.

    Single-process this is ``jax.device_put``.  Multi-process, every host
    holds the full array (the framework's ensembles are built from
    deterministic seeds/targets, so this is free) and contributes its
    addressable shards via ``make_array_from_callback`` — the standard
    way to form a global jax.Array without cross-host data movement.
    """
    if jax.process_count() > 1:
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
    return jax.device_put(x, sharding)
