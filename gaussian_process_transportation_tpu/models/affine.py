"""Kabsch/Procrustes affine alignment (γ in Φ = γ + Ψ∘γ).

Functional core + thin stateful wrapper; parity with
``policy_transportation/models/affine_trasformation.py:8-57``:
centroid alignment, SVD rotation with reflection fix, optional uniform
least-squares scale, and the degenerate-count guard (identity rotation when
fewer points than dimensions).

The fit is a tiny SVD — one fused XLA call — and `predict`/`derivative`
are pure broadcasts, so the whole γ stage stays on-device inside the jitted
transport pipeline.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

Array = jax.Array


@struct.dataclass
class AffineParams:
    rotation: Array  # (D, D)
    scale: Array  # scalar
    source_centroid: Array  # (D,)
    target_centroid: Array  # (D,)


def fit(
    source_points: Array,
    target_points: Array,
    do_scale: bool = False,
    do_rotation: bool = True,
) -> AffineParams:
    source_points = jnp.asarray(source_points)
    target_points = jnp.asarray(target_points)
    if source_points.shape != target_points.shape:
        raise ValueError(
            f"source and target point sets must have matching shapes; got "
            f"{source_points.shape} vs {target_points.shape}"
        )
    n, d = source_points.shape
    cs = jnp.mean(source_points, axis=0)
    ct = jnp.mean(target_points, axis=0)
    Xc = source_points - cs
    Yc = target_points - ct

    if do_rotation and n >= d:
        H = Xc.T @ Yc
        U, _, Vt = jnp.linalg.svd(H)
        V = Vt.T
        R = V @ U.T
        # reflection fix: flip the last singular direction if det < 0
        neg = jnp.linalg.det(R) < 0
        V_fixed = V.at[:, -1].multiply(jnp.where(neg, -1.0, 1.0))
        R = V_fixed @ U.T
    else:
        R = jnp.eye(d, dtype=source_points.dtype)

    if do_scale:
        src_rot = Xc @ R.T
        scale = jnp.sum(src_rot * Yc) / jnp.sum(src_rot * src_rot)
    else:
        scale = jnp.asarray(1.0, dtype=source_points.dtype)

    return AffineParams(rotation=R, scale=scale, source_centroid=cs, target_centroid=ct)


def predict(params: AffineParams, x: Array) -> Array:
    """γ(x) = s·R(x − c_S) + c_T (note: translation by centroid difference,
    reference ``affine_trasformation.py:51-53``)."""
    return params.scale * (x - params.source_centroid) @ params.rotation.T + params.target_centroid


def derivative(params: AffineParams, x: Array) -> Array:
    """J_γ per query point: constant s·R, broadcast to (N, D, D).

    Note: the reference returns R (without the scale factor,
    ``affine_trasformation.py:55-57``) even when do_scale=True; we include
    the scale for mathematical correctness but it is 1.0 in all reference
    workloads that consume the derivative.
    """
    J = params.scale * params.rotation
    return jnp.broadcast_to(J[None, :, :], (x.shape[0],) + J.shape)


def fit_batched(
    source_points: Array,
    target_points: Array,
    do_scale: bool = False,
    do_rotation: bool = True,
) -> AffineParams:
    """Kabsch fit of one source against a batch of targets (E, n, D);
    returns AffineParams with a leading E axis on every leaf.

    For D=2 the SO(2) optimum has a closed form — the angle maximizing
    tr(R Hᵀ) is atan2(H01 − H10, H00 + H11), identical to the SVD +
    reflection-fix result — which avoids E tiny batched SVDs.  Other D
    fall back to the vmapped SVD path.
    """
    source_points = jnp.asarray(source_points)
    target_points = jnp.asarray(target_points)
    n, d = source_points.shape
    if d != 2 or not do_rotation or n < d:
        return jax.vmap(
            lambda tgt: fit(source_points, tgt, do_scale=do_scale, do_rotation=do_rotation)
        )(target_points)

    cs = jnp.mean(source_points, axis=0)  # (2,)
    ct = jnp.mean(target_points, axis=1)  # (E, 2)
    Xc = source_points - cs  # (n, 2)
    Yc = target_points - ct[:, None, :]  # (E, n, 2)
    H = jnp.einsum("na,enb->eab", Xc, Yc)  # (E, 2, 2)
    theta = jnp.arctan2(H[:, 0, 1] - H[:, 1, 0], H[:, 0, 0] + H[:, 1, 1])
    c, s = jnp.cos(theta), jnp.sin(theta)
    R = jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )  # (E, 2, 2)
    if do_scale:
        src_rot = jnp.einsum("na,eba->enb", Xc, R)  # (E, n, 2) = Xc Rᵀ
        scale = jnp.einsum("enb,enb->e", src_rot, Yc) / jnp.einsum(
            "enb,enb->e", src_rot, src_rot
        )
    else:
        scale = jnp.ones_like(theta)
    E = target_points.shape[0]
    return AffineParams(
        rotation=R,
        scale=scale,
        source_centroid=jnp.broadcast_to(cs, (E, 2)),
        target_centroid=ct,
    )


class AffineTransform:
    """Stateful wrapper with the reference's interface."""

    def __init__(self, do_scale: bool = False, do_rotation: bool = True):
        self.do_scale = do_scale
        self.do_rotation = do_rotation
        self.params: AffineParams | None = None

    def fit(self, source_points, target_points):
        assert len(source_points) == len(target_points)
        self.params = fit(
            jnp.asarray(source_points),
            jnp.asarray(target_points),
            do_scale=self.do_scale,
            do_rotation=self.do_rotation,
        )
        return self

    @property
    def rotation_matrix(self):
        return self.params.rotation

    @property
    def scale(self):
        return self.params.scale

    @property
    def translation(self):
        return self.params.target_centroid - self.params.source_centroid

    def predict(self, x):
        return predict(self.params, jnp.asarray(x))

    def derivative(self, x):
        return derivative(self.params, jnp.asarray(x))
