"""Quaternion algebra in JAX (scalar-first [w, x, y, z] layout).

Replaces the reference's dependency on ``numpy-quaternion``
(``policy_transportation/transportation/policy_transportation.py:61-78``),
in particular ``from_rotation_matrix(..., nonorthogonal=True)``: the
Bar-Itzhack eigenvector method, which finds the *closest* unit quaternion to
an arbitrary (possibly non-orthogonal) 3×3 matrix — exactly what the
orientation transport needs, since J_Φ = J_γ + J_Ψ J_γ is generally not a
rotation.  All functions are jit/vmap-friendly; the batched path vmaps a
4×4 symmetric eigendecomposition.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def multiply(q1: Array, q2: Array) -> Array:
    """Hamilton product, scalar-first; broadcasts over leading dims."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def conjugate(q: Array) -> Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def normalize(q: Array) -> Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def from_rotation_matrix(R: Array) -> Array:
    """Closest unit quaternion(s) to matrix/matrices R, Bar-Itzhack (2000).

    Builds the symmetric 4×4 profile matrix K in the (x, y, z, w) basis; the
    unit eigenvector of its largest eigenvalue, reordered scalar-first, is
    the optimal quaternion.  Valid for non-orthogonal input (it solves the
    orthogonal-Procrustes problem on SO(3)).
    """
    R = jnp.asarray(R)
    batch = R.shape[:-2]
    Rf = R.reshape((-1, 3, 3))

    def one(m):
        K = jnp.array(
            [
                [
                    m[0, 0] - m[1, 1] - m[2, 2],
                    m[0, 1] + m[1, 0],
                    m[0, 2] + m[2, 0],
                    m[2, 1] - m[1, 2],
                ],
                [
                    m[0, 1] + m[1, 0],
                    m[1, 1] - m[0, 0] - m[2, 2],
                    m[1, 2] + m[2, 1],
                    m[0, 2] - m[2, 0],
                ],
                [
                    m[0, 2] + m[2, 0],
                    m[1, 2] + m[2, 1],
                    m[2, 2] - m[0, 0] - m[1, 1],
                    m[1, 0] - m[0, 1],
                ],
                [
                    m[2, 1] - m[1, 2],
                    m[0, 2] - m[2, 0],
                    m[1, 0] - m[0, 1],
                    m[0, 0] + m[1, 1] + m[2, 2],
                ],
            ]
        ) / 3.0
        _, vecs = jnp.linalg.eigh(K)
        v = vecs[:, -1]  # largest eigenvalue (eigh sorts ascending)
        q = jnp.array([v[3], v[0], v[1], v[2]])
        # canonical sign: non-negative scalar part
        return q * jnp.where(q[0] < 0, -1.0, 1.0)

    q = jax.vmap(one)(Rf)
    return q.reshape(batch + (4,))


def _profile_matrix(m: Array) -> Array:
    """Bar-Itzhack symmetric 4×4 profile matrix of a 3×3 matrix, batched:
    (..., 3, 3) → (..., 4, 4) in the (x, y, z, w) basis, scaled by 1/3."""
    r = lambda i, j: m[..., i, j]
    row0 = jnp.stack(
        [r(0, 0) - r(1, 1) - r(2, 2), r(0, 1) + r(1, 0),
         r(0, 2) + r(2, 0), r(2, 1) - r(1, 2)], axis=-1)
    row1 = jnp.stack(
        [r(0, 1) + r(1, 0), r(1, 1) - r(0, 0) - r(2, 2),
         r(1, 2) + r(2, 1), r(0, 2) - r(2, 0)], axis=-1)
    row2 = jnp.stack(
        [r(0, 2) + r(2, 0), r(1, 2) + r(2, 1),
         r(2, 2) - r(0, 0) - r(1, 1), r(1, 0) - r(0, 1)], axis=-1)
    row3 = jnp.stack(
        [r(2, 1) - r(1, 2), r(0, 2) - r(2, 0),
         r(1, 0) - r(0, 1), r(0, 0) + r(1, 1) + r(2, 2)], axis=-1)
    return jnp.stack([row0, row1, row2, row3], axis=-2) / 3.0


def from_rotation_matrix_iter(R: Array, squarings: int = 12) -> Array:
    """Batched Bar-Itzhack closest-quaternion via repeated matrix squaring
    — the ensemble path.

    Same optimum as :func:`from_rotation_matrix`, but with NO eigh call:
    a vmapped tiny (4×4) ``jnp.linalg.eigh`` is a batched library call of
    tiny matrices per point.  Here everything stays elementwise /
    tiny-batched-matmul: build the profile matrix K (spectrum in [-1, 1],
    λmax → 1 for near-rotations), shift B = K + 2I so the dominant
    eigenvalue is strictly the largest in magnitude, square ``squarings``
    times (renormalizing to dodge overflow) — B^(2^12) amplifies even a
    1.01 eigen-ratio by ~10^17 — and read the dominant eigenvector off the
    largest column.  Plain power iteration needed ~200 iterations in the
    small-gap tail; 12 squarings = effective power 4096 with 12 batched
    4×4 matmuls.

    Matches the eigh path to ~1e-6 across random rotations with up to 50%
    non-orthogonal perturbation (tests/test_affine_quaternion.py).
    """
    R = jnp.asarray(R)
    K = _profile_matrix(R)                       # (..., 4, 4)
    B = K + 2.0 * jnp.eye(4, dtype=R.dtype)
    for _ in range(squarings):
        B = jnp.einsum("...ik,...kj->...ij", B, B)
        B = B / jnp.max(jnp.abs(B), axis=(-2, -1), keepdims=True)
    # dominant eigenvector ≈ any column with non-vanishing projection;
    # the largest column maximizes that projection
    norms = jnp.linalg.norm(B, axis=-2)          # (..., 4) column norms
    pick = jax.nn.one_hot(jnp.argmax(norms, axis=-1), 4, dtype=R.dtype)
    v = jnp.einsum("...ij,...j->...i", B, pick)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    q = jnp.stack([v[..., 3], v[..., 0], v[..., 1], v[..., 2]], axis=-1)
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def to_rotation_matrix(q: Array) -> Array:
    """Unit quaternion(s) → rotation matrix/matrices."""
    q = normalize(q)
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1
    )
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1
    )
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)
