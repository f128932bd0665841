"""Linear assignment (trajectory-waypoint ↔ distribution-point matching).

The reference uses scipy's Hungarian algorithm on a dense distance matrix
(``models/laplacian_editing.py:31-41``, ``kernelized_movemement_primitives.py:10-27``).
Assignment is inherently sequential (SURVEY.md §7 "hard parts"), so we ship
two implementations:

* ``linear_sum_assignment`` — scipy (host): exact, used at fit time where
  the surrounding orchestration is host-side anyway.
* ``auction_assignment`` — ε-scaling forward auction in pure JAX
  (``lax.while_loop``): jittable, device-resident, optimal to within
  n·ε_final; used when matching must live inside a compiled pipeline
  (batched/ensemble fits).  Costs are minimized.

Both return (row_ind, col_ind) pairs sorted by row, matching scipy.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def distance_matrix(A: Array, B: Array) -> Array:
    """Pairwise Euclidean distances (N, M) — the matching cost used
    throughout the reference."""
    d2 = (
        jnp.sum(A * A, -1)[:, None]
        + jnp.sum(B * B, -1)[None, :]
        - 2.0 * A @ B.T
    )
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def linear_sum_assignment(cost) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Hungarian (host, scipy)."""
    from scipy.optimize import linear_sum_assignment as lsa

    r, c = lsa(np.asarray(cost))
    return r, c


@partial(jax.jit, static_argnames=("max_iter",))
def auction_assignment(cost: Array, eps_start: float = 1.0, max_iter: int = 10000) -> Array:
    """ε-scaling auction for square/rectangular assignment, minimizing cost.

    Persons are the *columns* (assumed the smaller side, e.g. distribution
    points); objects the rows.  Returns ``row_for_col``: for each column j,
    the assigned row index.  Jittable; O(iters · N·M) elementwise work.
    """
    C = jnp.asarray(cost)
    n_rows, n_real = C.shape
    if n_real > n_rows:
        raise ValueError("auction_assignment expects n_rows >= n_cols")
    # Pad to square with zero-cost dummy persons: the asymmetric problem
    # reduces to a symmetric one (dummies absorb unassigned rows), which the
    # forward auction solves to n·ε optimality; carried prices on
    # unassigned objects would otherwise break asymmetric optimality.
    n_cols = n_rows
    B = jnp.concatenate([-C, jnp.zeros((n_rows, n_rows - n_real))], axis=1)
    scale = jnp.maximum(jnp.max(jnp.abs(B)), 1.0)

    def run_eps(prices, eps):
        # Each ε-round restarts the assignment (standard ε-scaling keeps
        # only the prices between rounds).
        owner = jnp.full((n_rows,), -1, dtype=jnp.int32)
        assigned = jnp.full((n_cols,), -1, dtype=jnp.int32)

        def body(state):
            prices, owner, assigned, it = state
            # first unassigned person
            free = jnp.where(assigned < 0, jnp.arange(n_cols), n_cols)
            j = jnp.min(free).astype(jnp.int32)

            def bid(_):
                values = B[:, j] - prices  # (n_rows,)
                i_best = jnp.argmax(values).astype(jnp.int32)
                v_best = values[i_best]
                values2 = values.at[i_best].set(-jnp.inf)
                v_second = jnp.max(values2)
                bid_incr = v_best - v_second + eps
                new_prices = prices.at[i_best].add(bid_incr)
                # evict previous owner of i_best
                prev = owner[i_best]
                new_assigned = jnp.where(
                    prev >= 0,
                    assigned.at[prev].set(jnp.int32(-1)),
                    assigned,
                )
                new_assigned = new_assigned.at[j].set(i_best)
                new_owner = owner.at[i_best].set(j)
                return new_prices, new_owner, new_assigned

            prices, owner, assigned = jax.lax.cond(
                j < n_cols, bid, lambda _: (prices, owner, assigned), None
            )
            return prices, owner, assigned, it + 1

        def cond(state):
            _, _, assigned, it = state
            return jnp.logical_and(jnp.any(assigned < 0), it < max_iter)

        prices, owner, assigned, _ = jax.lax.while_loop(
            cond, body, (prices, owner, assigned, 0)
        )
        return prices, assigned

    n_scales = 10
    eps_schedule = scale * eps_start * (0.2 ** jnp.arange(n_scales))
    prices, assignments = jax.lax.scan(run_eps, jnp.zeros((n_rows,)), eps_schedule)
    return assignments[-1][:n_real]


def match_waypoints(training_traj, source_distribution):
    """(mask_traj, mask_dist): which trajectory waypoint matches which
    distribution point — scipy-exact, host-side (reference
    ``laplacian_editing.py:31-41``)."""
    D = np.asarray(
        distance_matrix(jnp.asarray(training_traj), jnp.asarray(source_distribution))
    )
    return linear_sum_assignment(D)
