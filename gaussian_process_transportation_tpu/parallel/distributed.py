"""Multi-host runtime helpers.

The reference is strictly single-process (SURVEY.md §2d).  Here the same
mesh-first code paths scale from 1 chip to a multi-host slice: call
:func:`initialize` once per process, then :func:`multihost_mesh` to lay the
'ens' axis across hosts (chains/ensemble members never communicate, so
their traffic pattern is DCN-friendly) and the 'data' axis within a host
(Gram/trajectory sharding rides the intra-host interconnect).

On a single host these degrade to the local helpers, so the driver's
virtual-CPU dry run and a real pod run share one code path.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """`jax.distributed.initialize` with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process."""
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address or os.environ["COORDINATOR_ADDRESS"],
        num_processes=num_processes,
        process_id=process_id if process_id is not None else int(os.environ["PROCESS_ID"]),
    )


def multihost_mesh(n_data_per_host: int = 1) -> Mesh:
    """(ens × data) mesh with 'ens' spanning hosts.

    Device order groups each host's local devices together, so the 'data'
    axis (which carries the within-problem collectives) never crosses the
    DCN boundary."""
    devices = jax.devices()
    n_hosts = jax.process_count()
    per_host = len(devices) // n_hosts
    n_data = min(n_data_per_host, per_host)
    n_ens = len(devices) // n_data
    arr = np.asarray(devices[: n_ens * n_data]).reshape(n_ens, n_data)
    return Mesh(arr, ("ens", "data"))


def process_local_slice(total: int) -> slice:
    """This process's contiguous shard of a length-``total`` ensemble axis
    (for host-local data feeding before a global device_put)."""
    p = jax.process_index()
    n = jax.process_count()
    per = total // n
    return slice(p * per, (p + 1) * per if p < n - 1 else total)
