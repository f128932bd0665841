"""Batched transport engine: batched small SPD inverse, closed-form 2-D
Kabsch, and fit_and_transport_batched parity against the vmapped
reference path."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models import affine as affine_core
from gaussian_process_transportation_tpu.ops.batched_linalg import spd_inverse
from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

rng = np.random.RandomState(3)


def _spd_batch(n=13, E=6):
    A = rng.randn(E, n, n)
    return jnp.asarray(A @ np.transpose(A, (0, 2, 1)) + n * np.eye(n))  # (E, n, n)


def test_cholesky_elast_matches_jnp():
    """The batched factor equals a per-matrix Cholesky (float64)."""
    K = _spd_batch()
    L, _ = spd_inverse(K)
    ref = np.stack([np.linalg.cholesky(k) for k in np.asarray(K)])
    np.testing.assert_allclose(np.asarray(L), ref, rtol=1e-10, atol=1e-10)


def test_inv_lower_and_spd_inverse():
    K = _spd_batch()
    L, Kinv = spd_inverse(K)
    n = K.shape[-1]
    for e in range(K.shape[0]):
        np.testing.assert_allclose(
            np.asarray(Kinv)[e] @ np.asarray(K)[e], np.eye(n), atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(L)[e] @ np.asarray(L)[e].T, np.asarray(K)[e], atol=1e-8
        )


def test_fit_batched_2d_matches_svd_path():
    src = rng.randn(15, 2)
    tgts = jnp.asarray(rng.randn(5, 15, 2) + src[None] @ np.array([[0.8, -0.6], [0.6, 0.8]]).T)
    for do_scale in (False, True):
        got = affine_core.fit_batched(src, tgts, do_scale=do_scale)
        ref = jax.vmap(lambda t: affine_core.fit(jnp.asarray(src), t, do_scale=do_scale))(tgts)
        np.testing.assert_allclose(np.asarray(got.rotation), np.asarray(ref.rotation), atol=1e-9)
        np.testing.assert_allclose(np.asarray(got.scale), np.asarray(ref.scale), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(got.target_centroid), np.asarray(ref.target_centroid), atol=1e-12
        )
        # proper rotations only (reflection fix built into the SO(2) optimum)
        dets = np.linalg.det(np.asarray(got.rotation))
        np.testing.assert_allclose(dets, 1.0, atol=1e-9)


def test_fit_and_transport_batched_parity():
    """The batched engine must reproduce vmap(fit_and_transport) exactly
    (same math, different layout/algorithms) on the bench's 2-D drawing
    (demo curve, floor and new-floor distributions) with seeded targets."""
    from gaussian_process_transportation_tpu.utils.resample import resample

    t = np.linspace(0, 1, 400)
    demo = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, 20)
    floor = np.stack([10 * s, -2 + 0 * s], 1)
    newfloor = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    X = resample(jnp.asarray(demo, jnp.float64), num_points=120)
    S = resample(jnp.asarray(floor, jnp.float64), num_points=20)
    S1 = resample(jnp.asarray(newfloor, jnp.float64), num_points=20)
    dX = jnp.zeros_like(X).at[:-1].set(jnp.diff(X, axis=0))
    kern = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.01)
    E = 5
    shifts = np.random.default_rng(0).uniform(-1.0, 1.0, (E, 1, 2))
    targets = S1[None] + jnp.asarray(shifts)

    ref = jax.vmap(lambda t: gpt_mod.fit_and_transport(kern, S, t, X, dX))(targets)
    got = gpt_mod.fit_and_transport_batched(kern, S, targets, X, dX)
    for name in ("traj", "std", "delta", "delta_var", "min_abs_det"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(ref, name)),
            rtol=1e-9,
            atol=1e-9,
            err_msg=name,
        )


def test_fit_and_transport_batched_large_n_fallback():
    """n > 64 takes the vmapped path; results must still match."""
    t = np.linspace(0, 1, 80)
    S = jnp.asarray(np.stack([t * 10, np.sin(t)], axis=1))
    targets = S[None] + jnp.asarray([0.5, 1.0])[:, None, None]
    X = S + 0.1
    dX = jnp.zeros_like(X).at[:-1].set(jnp.diff(X, axis=0))
    kern = K.Constant(1.0) * K.RBF(2.0 * jnp.ones(2)) + K.White(0.01)
    ref = jax.vmap(lambda tg: gpt_mod.fit_and_transport(kern, S, tg, X, dX))(targets)
    got = gpt_mod.fit_and_transport_batched(kern, S, targets, X, dX)
    np.testing.assert_allclose(np.asarray(got.traj), np.asarray(ref.traj), atol=1e-10)
