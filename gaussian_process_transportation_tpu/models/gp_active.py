"""Active-learning exact GP: informative-subset selection for large N.

Parity target: ``policy_transportation/models/gaussian_process_al.py:15-107``
— when n_samples > n_samples_max (20 000), the reference seeds with a
random 10% subset and then greedily adds the max-posterior-std point,
REFITTING the whole sklearn GP (including hyperopt) each iteration —
O(iters · N³) with Python in the loop.

Re-design: greedy max-variance selection with fixed hyperparameters is
exactly *partial pivoted Cholesky* on the kernel matrix — each step picks
the point with the largest Schur-complement diagonal (= posterior variance
given the already-selected points) and updates the diagonal with one kernel
column.  One ``lax.fori_loop``, O(M·N) kernel evaluations and O(M²·N)
FLOPs total, no refits.  Hyperparameters are then optimized once on the
selected subset.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import Kernel
from . import exact_gp as core

Array = jax.Array


@partial(jax.jit, static_argnames=("m",))
def greedy_variance_select(
    kernel: Kernel, X: Array, m: int, seed_idx: Array, noise: float = 0.0
) -> Array:
    """Indices of an m-point subset: ``seed_idx`` first, then greedy
    max-posterior-variance additions via partial pivoted Cholesky.

    seed_idx: (m0,) pre-selected indices (the reference's random 10% seed);
    returns (m,) int32 indices.  ``noise`` must equal the kernel's additive
    White level: ``kernel.diag`` already includes it, and it is re-added to
    the cross-covariance column diagonal (two-argument kernel calls drop
    White) so the pivoted factorization sees one consistent matrix."""
    N = X.shape[0]
    m0 = seed_idx.shape[0]
    d = kernel.diag(X)  # current conditional variances (incl. White)
    chosen = jnp.full((m,), -1, dtype=jnp.int32)
    chosen = chosen.at[:m0].set(seed_idx.astype(jnp.int32))
    # L_rows[j] = j-th row of the pivoted-Cholesky factor evaluated at all N
    L_rows = jnp.zeros((m, N), dtype=X.dtype)

    def body(j, carry):
        d, chosen, L_rows = carry
        # pick: seeded index for j < m0, else argmax of conditional variance
        masked_d = jnp.where(
            jnp.isin(jnp.arange(N), chosen, assume_unique=False), -jnp.inf, d
        )
        pick = jnp.where(j < m0, chosen[j], jnp.argmax(masked_d).astype(jnp.int32))
        chosen = chosen.at[j].set(pick)

        k_col = kernel(X, X[pick][None, :])[:, 0]  # (N,) prior cross-cov
        k_col = k_col + noise * (jnp.arange(N) == pick)
        # Schur update: l_j = (k_col − Σ_{i<j} L_i[pick]·L_i) / sqrt(d[pick])
        proj = L_rows[:, pick] @ L_rows  # (N,)
        pivot = jnp.sqrt(jnp.maximum(d[pick], 1e-12))
        # kernel params may be f64 under x64 while X (and L_rows) are f32 —
        # scatter of a wider dtype is a FutureError in jax
        l_j = ((k_col - proj) / pivot).astype(L_rows.dtype)
        L_rows = L_rows.at[j].set(l_j)
        d = jnp.maximum(d - l_j**2, 0.0)
        return d, chosen, L_rows

    _, chosen, _ = jax.lax.fori_loop(0, m, body, (d, chosen, L_rows))
    return chosen


class GaussianProcessActiveLearning:
    """Reference-interface wrapper (``gaussian_process_al.py``): ``fit``
    subsamples when N exceeds ``n_samples_max``; ``predict`` returns
    (mean, epistemic std); ``derivative`` returns (dy/dx, dσ²/dx) with the
    reference's (Nq, D, P) / (Nq, D, 1) layouts."""

    def __init__(
        self,
        kernel: Kernel,
        alpha: float = 1e-10,
        n_restarts_optimizer: int = 5,
        n_samples_max: int = 20000,
        seed: int = 0,
        use_blocked: bool = False,
        blocked_kwargs: Optional[dict] = None,
    ):
        self.kernel = kernel
        self.alpha = alpha
        self.n_restarts_optimizer = n_restarts_optimizer
        self.n_samples_max = n_samples_max
        self.seed = seed
        # use_blocked: route the (subset) hyperopt through the panel-LML
        # fit (models.exact_gp.fit_blocked, C·stationary(+White) family)
        # instead of the dense scipy fit (dense is faster on the H100,
        # PERF.md).  The reference's n_samples_max=20000
        # exists because sklearn's dense fit is impractical above it
        # (gaussian_process_al.py:16).
        self.use_blocked = use_blocked
        self.blocked_kwargs = dict(blocked_kwargs or {})
        self.state: Optional[core.ExactGP] = None

    def fit(self, X, Y):
        X = jnp.asarray(X)
        Y = jnp.asarray(Y if np.ndim(Y) == 2 else np.asarray(Y)[:, None])
        n = X.shape[0]
        if n > self.n_samples_max:
            key = jax.random.PRNGKey(self.seed)
            n_initial = int(0.1 * self.n_samples_max)
            seed_idx = jax.random.choice(key, n, (n_initial,), replace=False)
            idx = greedy_variance_select(
                self.kernel, X, self.n_samples_max, seed_idx,
                noise=float(core.white_noise_level(self.kernel)),
            )
            X, Y = X[idx], Y[idx]
        if self.use_blocked:
            self.state = core.fit_blocked(
                self.kernel,
                X.astype(jnp.float32),
                Y.astype(jnp.float32),
                jitter=self.alpha,
                **self.blocked_kwargs,
            )
        else:
            self.state = core.fit(
                self.kernel, X, Y,
                n_restarts=self.n_restarts_optimizer,
                key=jax.random.PRNGKey(self.seed + 1),
                jitter=self.alpha,
            )
        self.kernel_ = self.state.kernel
        return self

    @property
    def X(self):
        return self.state.X

    def predict(self, x):
        return core.predict(self.state, jnp.asarray(x), return_std=True, epistemic_only=True)

    def derivative(self, x):
        x = jnp.asarray(x)
        dy = core.jacobian(self.state, x)  # (Nq, P, D)
        dy_dx = jnp.transpose(dy, (0, 2, 1))  # reference layout (Nq, D, P)
        dsigma_dx = core.variance_gradient(self.state, x)[:, :, None]  # (Nq, D, 1)
        return dy_dx, dsigma_dx
