"""Obstacle geometry: Γ distance functions and modulation bases.

Re-designs ``policy_transportation/obstacle_avoidance/obstacle_avoidance_Linear_DS.py:38-201``
as batched pure functions.  Obstacles are a struct-of-arrays pytree
(``Obstacles``) so every Γ/basis evaluation is vmapped over BOTH the
obstacle axis and the agent axis — the reference's per-obstacle /
per-agent Python loops become one fused program (its 50-agent rollout,
``dynamic_modulation_2019.py:34-74``, is a single batched matmul chain here).
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

Array = jax.Array


@struct.dataclass
class Obstacles:
    """Struct-of-arrays over K obstacles (2-D).

    ``is_ellipse``: 1.0 for ellipse, 0.0 for cuboid — kept as a float mask
    so mixed scenes stay vectorized (both Γs are computed and blended by
    the mask; K is small)."""

    center: Array  # (K, 2)
    reference_point: Array  # (K, 2) in the obstacle frame
    axis_length: Array  # (K, 2) full axis lengths (d1, d2)
    orientation: Array  # (K,) degrees (reference uses degrees)
    margin: Array  # (K,)
    repulsion_coeff: Array  # (K,)
    linear_velocity: Array  # (K, 2)
    angular_velocity: Array  # (K,) rad/s (0 = none)
    is_ellipse: Array  # (K,) 1.0 ellipse / 0.0 cuboid

    @staticmethod
    def from_dicts(obstacles: list) -> "Obstacles":
        """Build from the reference's list-of-dicts format
        (``example/2D/surface_generalization.py:111-127``)."""
        import numpy as np

        def get(o, k, d):
            v = o.get(k, d)
            return d if v is None else v

        return Obstacles(
            center=jnp.asarray(np.stack([np.asarray(o["center"], float) for o in obstacles])),
            reference_point=jnp.asarray(
                np.stack([np.asarray(get(o, "reference_point", np.zeros(2)), float) for o in obstacles])
            ),
            axis_length=jnp.asarray(np.stack([np.asarray(o["axis_length"], float) for o in obstacles])),
            orientation=jnp.asarray([float(get(o, "orientation", 0.0)) for o in obstacles]),
            margin=jnp.asarray([float(get(o, "margin", 0.0)) for o in obstacles]),
            repulsion_coeff=jnp.asarray([float(get(o, "repulsion_coeff", 1.0)) for o in obstacles]),
            linear_velocity=jnp.asarray(
                np.stack([np.asarray(get(o, "linear_velocity", np.zeros(2)), float) for o in obstacles])
            ),
            angular_velocity=jnp.asarray([float(get(o, "angular_velocity", 0.0)) for o in obstacles]),
            is_ellipse=jnp.asarray([1.0 if o.get("shape", "ellipse") == "ellipse" else 0.0 for o in obstacles]),
        )


def rotation2d(angle_rad: Array) -> Array:
    c, s = jnp.cos(angle_rad), jnp.sin(angle_rad)
    return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])


def _to_obstacle_frame(obs_center, orientation_deg, x):
    """x: (..., 2) world → obstacle-aligned frame."""
    R = rotation2d(jnp.radians(orientation_deg))
    return (x - obs_center) @ R  # == R.T @ (x-c) row-wise


def gamma_ellipse(x: Array, center, axis_length, orientation_deg, margin) -> Array:
    """Γ for an ellipse (reference ``get_gamma_ellipse``, lines 136-166):
    Γ = ‖ζ − surface_point‖ + 1 outside, ‖ζ‖/‖surface‖ inside.
    x: (N, 2) agents → (N,)."""
    z = _to_obstacle_frame(center, orientation_deg, x)  # (N, 2)
    semi = axis_length / 2.0
    circ = z / (semi + margin)
    pos_norm = jnp.linalg.norm(circ, axis=-1)
    safe = jnp.maximum(pos_norm, 1e-12)
    surface = z / safe[:, None]
    dist_surface = jnp.linalg.norm(surface, axis=-1)
    dist_z = jnp.linalg.norm(z, axis=-1)
    outside = dist_z > dist_surface
    d = jnp.where(
        outside,
        jnp.linalg.norm(z - surface, axis=-1),
        dist_z / jnp.maximum(dist_surface, 1e-12) - 1.0,
    )
    return d + 1.0


def gamma_cuboid(x: Array, center, axis_length, orientation_deg, margin) -> Array:
    """Γ for a cuboid (reference ``get_gamma_cuboid``/``get_distance_to_surface``,
    lines 169-201)."""
    z = _to_obstacle_frame(center, orientation_deg, x)
    semi = axis_length / 2.0
    rel = jnp.abs(z) - semi  # (N, 2)
    any_out = jnp.any(rel > 0, axis=-1)
    rel_pos = jnp.maximum(rel, 0.0)
    dist_out = jnp.linalg.norm(rel_pos, axis=-1)
    surf_out = jnp.where(dist_out > margin, dist_out - margin, margin - dist_out)
    d_in = margin - jnp.max(rel, axis=-1)
    z_norm = jnp.linalg.norm(z, axis=-1)
    surf_in = -(d_in / jnp.maximum(z_norm + d_in, 1e-12))
    dist_surface = jnp.where(any_out, surf_out, surf_in)
    gamma_out = dist_surface + 1.0
    gamma_in = z_norm / jnp.maximum(z_norm - dist_surface, 1e-12)
    return jnp.where(dist_surface < 0, gamma_in, gamma_out)


def gamma(obs: Obstacles, x: Array) -> Array:
    """Γ for every obstacle and agent: (K, N)."""

    def per_obs(center, axis_length, orientation, margin, is_ell):
        ge = gamma_ellipse(x, center, axis_length, orientation, margin)
        gc = gamma_cuboid(x, center, axis_length, orientation, margin)
        return is_ell * ge + (1.0 - is_ell) * gc

    return jax.vmap(per_obs)(
        obs.center, obs.axis_length, obs.orientation, obs.margin, obs.is_ellipse
    )


def modulation_bases(obs: Obstacles, x: Array):
    """E (reference-direction basis), E_ortho (normal basis), Γ for every
    (obstacle, agent): shapes (K, N, 2, 2), (K, N, 2, 2), (K, N).

    Parity with ``single_obstacle_modulation_matrix`` (lines 38-134):
    column 0 of E is r̂ (direction from the reference point), column 1 is
    the tangent e = n × ẑ; E_ortho has n̂ in column 0."""

    def per_obs(center, ref_point, axis_length, orientation, margin, is_ell):
        th = jnp.radians(orientation)
        R = rotation2d(th)
        ref_world = R @ ref_point + center
        r = x - ref_world  # (N, 2)
        r_norm = jnp.linalg.norm(r, axis=-1, keepdims=True)
        r_hat = jnp.where(r_norm > 0, r / jnp.maximum(r_norm, 1e-12), 0.5)

        z = (x - center) @ R  # obstacle frame
        # ellipse normal: gradient of the level-set function
        d = axis_length + 2.0 * margin
        n_ell = jnp.stack([2.0 * z[:, 0] / d[0] ** 2, 2.0 * z[:, 1] / d[1] ** 2], axis=-1)
        # cuboid normal: offset beyond the face
        semi = axis_length / 2.0
        relevant = jnp.abs(z) > semi
        n_cub = jnp.where(relevant, z - semi * jnp.sign(z), 0.0)
        n_vec = is_ell * n_ell + (1.0 - is_ell) * n_cub
        n_norm = jnp.linalg.norm(n_vec, axis=-1, keepdims=True)
        n_unit = jnp.where(
            n_norm > 0,
            n_vec / jnp.maximum(n_norm, 1e-12),
            jnp.asarray([1.0, 0.0]),
        )
        n_world = n_unit @ R.T  # back to world frame

        # tangent: e = n × ẑ in 2-D → (n_y, -n_x)
        e = jnp.stack([n_world[:, 1], -n_world[:, 0]], axis=-1)

        E_ortho = jnp.stack([n_world, e], axis=-1)  # columns [n, e]
        E = jnp.stack([r_hat, e], axis=-1)  # columns [r̂, e]

        ge = gamma_ellipse(x, center, axis_length, orientation, margin)
        gc = gamma_cuboid(x, center, axis_length, orientation, margin)
        g = is_ell * ge + (1.0 - is_ell) * gc
        return E, E_ortho, g

    return jax.vmap(per_obs)(
        obs.center,
        obs.reference_point,
        obs.axis_length,
        obs.orientation,
        obs.margin,
        obs.is_ellipse,
    )


def obstacle_weights(gammas: Array) -> Array:
    """Multi-obstacle weights ω_k (reference ``omega_denominator`` +
    numerator product, lines 204-244): ω_k = Π_{i≠k}(Γ_i−1) / Σ_j Π_{i≠j}(Γ_i−1).
    gammas: (K, N) → (K, N)."""
    K = gammas.shape[0]
    gm1 = gammas - 1.0  # (K, N)

    def numer(k):
        mask = jnp.arange(K) != k
        return jnp.prod(jnp.where(mask[:, None], gm1, 1.0), axis=0)

    numerators = jax.vmap(numer)(jnp.arange(K))  # (K, N)
    denom = jnp.sum(numerators, axis=0)
    return numerators / jnp.maximum(denom, 1e-30)
