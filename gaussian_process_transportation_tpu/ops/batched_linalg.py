"""Linear algebra for huge batches of tiny SPD matrices.

Two forms, for two needs:

* :func:`spd_inverse` — the transport fit stage (``transport/gpt.py``)
  inverts E≈10⁴ Gram matrices of n≈20 points at once.  One batched
  Cholesky, one batched triangular solve and one batched product do it;
  XLA hands the first two to cuSOLVER/cuBLAS batched routines on a GPU
  (measured against an unrolled chain in ``PERF.md``).
* The ensemble-last (E-last) chain — :func:`cholesky_elast`,
  :func:`inv_lower_elast`, :func:`sum_lanes` — for the small-n LML of
  ``ops/fused_lml.py``.  Every lane runs the same elementwise program with
  a fixed order of adds, so a lane's result does not depend on how many
  lanes share the call.  Batched library routines give no such promise
  (on an H100 a lane's bits changed between 16- and 64-lane calls,
  ``PERF.md``), and sharded vs unsharded hyperposterior chains must agree
  bit for bit (``parallel/samplers.py``).  Unrolled over the static n, so
  only for small n.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def spd_inverse(K: Array) -> tuple[Array, Array]:
    """(L, K⁻¹) of a batch of SPD matrices K (E, n, n), K⁻¹ = L⁻ᵀ L⁻¹."""
    L = jnp.linalg.cholesky(K)
    eye = jnp.broadcast_to(jnp.eye(K.shape[-1], dtype=K.dtype), K.shape)
    Li = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    K_inv = jnp.einsum(
        "eki,ekj->eij", Li, Li, precision=jax.lax.Precision.HIGHEST
    )
    return L, K_inv


def sum_lanes(x: Array) -> Array:
    """Sum of x (m, ..., E) over its leading axis by pairwise halving: a
    fixed order of elementwise adds, the same whatever E is."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[:1])], axis=0)
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def cholesky_elast(K: Array) -> Array:
    """Lower Cholesky of K (n, n, E) — one (n,n) SPD matrix per lane.

    Left-looking column algorithm unrolled over the static n; column j
    subtracts its update Σ_{k<j} L[:, k]·L[j, k] as one product summed by
    :func:`sum_lanes`."""
    n = K.shape[0]
    rows = jnp.arange(n)[:, None]
    cols = []  # cols[j]: (n, E) = column j of L (zeros above the diagonal)
    for j in range(n):
        v = K[:, j]
        if j:
            C = jnp.stack(cols, axis=0)                       # (j, n, E)
            v = v - sum_lanes(C * C[:, j][:, None, :])
        cols.append(jnp.where(rows >= j, v * jax.lax.rsqrt(v[j]), 0.0))
    return jnp.stack(cols, axis=1)  # (n, n, E)


def inv_lower_elast(L: Array) -> Array:
    """Inverse of a lower-triangular L (n, n, E), row by row:
    L⁻¹[i] = (e_i − Σ_{k<i} L[i, k]·L⁻¹[k]) / L[i, i]."""
    n = L.shape[0]
    eye = jnp.eye(n, dtype=L.dtype)[:, :, None]
    out = []
    for i in range(n):
        r = jnp.broadcast_to(eye[i], L.shape[1:])             # (n, E)
        if i:
            r = r - sum_lanes(L[i, :i][:, None, :] * jnp.stack(out, axis=0))
        out.append(r / L[i, i])
    return jnp.stack(out, axis=0)  # (n, n, E)
