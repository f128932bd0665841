"""Laplacian trajectory editing.

Parity with ``policy_transportation/models/laplacian_editing.py:6-87``:
build the path- or cycle-graph Laplacian of the trajectory (cycle when the
endpoints are closer than 5× the max segment length), Hungarian-match
waypoints to distribution points, then solve the soft-constrained system

    [L ]        [L X        ]
    [P̂ ] P_s =  [X + Δ at matched waypoints]

in least squares, preserving local differential coordinates while moving the
matched waypoints by (target − source).  Deterministic; ``predict`` returns
the precomputed edited trajectory with ε std.

Design notes: the Laplacian is built directly as a banded matrix (no networkx)
and the solve is one ``jnp.linalg.lstsq`` — a single XLA QR on device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.assignment import match_waypoints

Array = jax.Array


def is_cycle(training_traj: Array, factor: float = 5.0) -> bool:
    seg = jnp.linalg.norm(training_traj[1:] - training_traj[:-1], axis=1)
    thr = factor * jnp.max(seg)
    return bool(jnp.linalg.norm(training_traj[0] - training_traj[-1]) < thr)


def graph_laplacian(n: int, cycle: bool) -> Array:
    """Path/cycle graph Laplacian as a dense jnp array."""
    main = 2.0 * jnp.ones(n)
    if not cycle:
        main = main.at[0].set(1.0).at[-1].set(1.0)
    L = jnp.diag(main) - jnp.diag(jnp.ones(n - 1), 1) - jnp.diag(jnp.ones(n - 1), -1)
    if cycle:
        L = L.at[0, -1].add(-1.0).at[-1, 0].add(-1.0)
    return L


def edit(
    training_traj: Array,
    source_distribution: Array,
    target_distribution: Array,
    mask_traj: Optional[np.ndarray] = None,
    mask_dist: Optional[np.ndarray] = None,
) -> Array:
    """Solve the Laplacian-editing least-squares system; returns P_s (N, D)."""
    training_traj = jnp.asarray(training_traj)
    n = training_traj.shape[0]
    cycle = is_cycle(training_traj)
    L = graph_laplacian(n, cycle)
    DELTA = L @ training_traj

    if mask_traj is None:
        mask_traj, mask_dist = match_waypoints(training_traj, source_distribution)

    diff = jnp.zeros_like(training_traj)
    diff = diff.at[mask_traj].set(
        jnp.asarray(target_distribution)[mask_dist]
        - jnp.asarray(source_distribution)[mask_dist]
    )
    constraint = jnp.zeros_like(training_traj)
    constraint = constraint.at[mask_traj].set(
        training_traj[mask_traj] + diff[mask_traj]
    )
    vect = jnp.zeros(n).at[mask_traj].set(1.0)
    P_hat = jnp.diag(vect)

    A = jnp.vstack([L, P_hat])
    B = jnp.vstack([DELTA, constraint])
    P_s, *_ = jnp.linalg.lstsq(A, B)
    return P_s


class LaplacianEditing:
    """Duck-typed model wrapper (reference interface)."""

    def __init__(self):
        self.P_s: Optional[Array] = None

    def fit(self, source_distribution, target_distribution, training_traj):
        self.training_traj = jnp.asarray(training_traj)
        self.P_s = edit(self.training_traj, source_distribution, target_distribution)
        return self

    def predict(self, X, return_std: bool = False):
        mean = self.P_s
        if return_std:
            return mean, 1e-6 * jnp.ones_like(mean)
        return mean

    def samples(self, X, n_samples: int = 10):
        return jnp.repeat(self.predict(X)[None], n_samples, axis=0)
