"""Dense PSD linear algebra helpers on top of XLA's batched kernels.

All functions are jit/vmap-friendly and shape-static.  XLA lowers
``cholesky``/``triangular_solve`` to cuSOLVER/cuBLAS on a GPU and LAPACK
on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def add_diagonal(K: Array, value) -> Array:
    """K + value * I without materializing an identity (fuses into the consumer)."""
    n = K.shape[-1]
    idx = jnp.arange(n)
    return K.at[..., idx, idx].add(value)


def cholesky_with_jitter(K: Array, jitter: float = 0.0) -> Array:
    """Lower Cholesky of K (+ jitter·I).  NaN rows signal non-PSD input;
    callers on the optimization path treat NaN as -inf likelihood."""
    if jitter:
        K = add_diagonal(K, jitter)
    return jnp.linalg.cholesky(K)


def tri_solve_lower(L: Array, B: Array) -> Array:
    """Solve L x = B with L lower triangular."""
    return jax.scipy.linalg.solve_triangular(L, B, lower=True)


def cho_solve_lower(L: Array, B: Array) -> Array:
    """Solve (L Lᵀ) x = B given lower Cholesky L."""
    y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def log_det_from_chol(L: Array) -> Array:
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
