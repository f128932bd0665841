import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu.models import affine as affine_core
from gaussian_process_transportation_tpu.models import AffineTransform
from gaussian_process_transportation_tpu.ops import quaternion as quat

rng = np.random.RandomState(7)


def _reference_kabsch(src, tgt, do_scale=False, do_rotation=True):
    """The reference's algorithm (affine_trasformation.py:15-49) re-expressed
    in numpy for golden values."""
    cs, ct = src.mean(0), tgt.mean(0)
    Xc, Yc = src - cs, tgt - ct
    d = src.shape[1]
    if not do_rotation or (d == 2 and len(src) < 2) or (d == 3 and len(src) < 3):
        R = np.eye(d)
    else:
        H = Xc.T @ Yc
        U, S, Vt = np.linalg.svd(H)
        V = Vt.T
        R = V @ U.T
        if np.linalg.det(R) < 0:
            V[:, -1] *= -1
            R = V @ U.T
    scale = 1.0
    if do_scale:
        src_rot = (R @ Xc.T).T
        scale = np.sum(src_rot * Yc) / np.sum(src_rot**2)
    return R, scale, cs, ct


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("do_scale", [False, True])
def test_affine_matches_reference_kabsch(d, do_scale):
    src = rng.randn(20, d)
    theta = 0.7
    R_true = np.eye(d)
    R_true[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    tgt = 1.3 * src @ R_true.T + 2.0 + 0.01 * rng.randn(20, d)

    R, s, cs, ct = _reference_kabsch(src, tgt, do_scale=do_scale)
    p = affine_core.fit(jnp.asarray(src), jnp.asarray(tgt), do_scale=do_scale)
    np.testing.assert_allclose(np.asarray(p.rotation), R, atol=1e-10)
    np.testing.assert_allclose(float(p.scale), s, atol=1e-10)

    x = rng.randn(9, d)
    expected = s * (R @ (x - cs).T).T + ct
    np.testing.assert_allclose(np.asarray(affine_core.predict(p, jnp.asarray(x))), expected, atol=1e-9)


def test_affine_reflection_fix():
    """A mirrored target must still produce a proper rotation (det=+1)."""
    src = rng.randn(15, 2)
    tgt = src * np.array([1.0, -1.0])  # reflection
    p = affine_core.fit(jnp.asarray(src), jnp.asarray(tgt))
    assert float(jnp.linalg.det(p.rotation)) > 0


def test_affine_degenerate_identity():
    """Fewer points than dimensions → identity rotation
    (affine_trasformation.py:25-26)."""
    src = rng.randn(2, 3)
    tgt = rng.randn(2, 3)
    p = affine_core.fit(jnp.asarray(src), jnp.asarray(tgt))
    np.testing.assert_allclose(np.asarray(p.rotation), np.eye(3), atol=1e-12)


def test_affine_wrapper_interface():
    src, tgt = rng.randn(10, 2), rng.randn(10, 2)
    a = AffineTransform(do_scale=True).fit(src, tgt)
    assert a.predict(src).shape == (10, 2)
    J = a.derivative(src)
    assert J.shape == (10, 2, 2)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def _random_rotation(key):
    q = jax.random.normal(key, (4,))
    return quat.to_rotation_matrix(q / jnp.linalg.norm(q))


def test_quaternion_roundtrip_orthogonal():
    keys = jax.random.split(jax.random.PRNGKey(0), 20)
    for k in keys:
        R = _random_rotation(k)
        q = quat.from_rotation_matrix(R)
        R2 = quat.to_rotation_matrix(q)
        np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-9)


def test_quaternion_multiply_matches_rotation_composition():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    R1, R2 = _random_rotation(k1), _random_rotation(k2)
    q1, q2 = quat.from_rotation_matrix(R1), quat.from_rotation_matrix(R2)
    q12 = quat.multiply(q1, q2)
    np.testing.assert_allclose(
        np.asarray(quat.to_rotation_matrix(q12)), np.asarray(R1 @ R2), atol=1e-9
    )


def test_quaternion_nonorthogonal_is_procrustes_projection():
    """Bar-Itzhack on a non-orthogonal matrix must give the SO(3) projection
    (SVD with det fix) — the behavior numpy-quaternion's
    from_rotation_matrix(nonorthogonal=True) provides to
    policy_transportation.py:70."""
    for seed in range(10):
        M = np.asarray(_random_rotation(jax.random.PRNGKey(seed))) + 0.2 * rng.randn(3, 3)
        q = quat.from_rotation_matrix(jnp.asarray(M))
        R_mine = np.asarray(quat.to_rotation_matrix(q))
        U, _, Vt = np.linalg.svd(M)
        R_proj = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
        np.testing.assert_allclose(R_mine, R_proj, atol=1e-7)


def test_quaternion_batched():
    Rs = jnp.stack([_random_rotation(k) for k in jax.random.split(jax.random.PRNGKey(1), 5)])
    qs = quat.from_rotation_matrix(Rs)
    assert qs.shape == (5, 4)
    np.testing.assert_allclose(
        np.asarray(quat.to_rotation_matrix(qs)), np.asarray(Rs), atol=1e-9
    )


def test_quaternion_matches_scipy_rotation():
    """Golden check vs scipy.spatial.transform.Rotation on orthogonal
    matrices (sign-canonicalized)."""
    from scipy.spatial.transform import Rotation

    for seed in range(10):
        R = np.asarray(_random_rotation(jax.random.PRNGKey(100 + seed)), dtype=float)
        q_mine = np.asarray(quat.from_rotation_matrix(jnp.asarray(R)))  # wxyz
        q_scipy = Rotation.from_matrix(R).as_quat()  # xyzw
        q_scipy = np.concatenate([[q_scipy[3]], q_scipy[:3]])
        if q_scipy[0] < 0:
            q_scipy = -q_scipy
        np.testing.assert_allclose(q_mine, q_scipy, atol=1e-7)


def test_quaternion_to_matrix_matches_scipy():
    from scipy.spatial.transform import Rotation

    q = np.asarray([0.5, 0.5, -0.5, 0.5])  # wxyz
    R_mine = np.asarray(quat.to_rotation_matrix(jnp.asarray(q)))
    R_scipy = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
    np.testing.assert_allclose(R_mine, R_scipy, atol=1e-12)


def test_from_rotation_matrix_iter_matches_numpy_eigh():
    """The squaring-based batched Bar-Itzhack (the ensemble path — no
    per-point eigh custom call) must match an independent numpy eigh
    implementation of Bar-Itzhack (2000) on rotations with up to 50%
    non-orthogonal perturbation."""
    rs = np.random.RandomState(11)

    def np_bar_itzhack(m):
        Kp = np.array([
            [m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0],
             m[0, 2] + m[2, 0], m[2, 1] - m[1, 2]],
            [m[0, 1] + m[1, 0], m[1, 1] - m[0, 0] - m[2, 2],
             m[1, 2] + m[2, 1], m[0, 2] - m[2, 0]],
            [m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
             m[2, 2] - m[0, 0] - m[1, 1], m[1, 0] - m[0, 1]],
            [m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
             m[1, 0] - m[0, 1], m[0, 0] + m[1, 1] + m[2, 2]],
        ]) / 3.0
        _, vecs = np.linalg.eigh(Kp)
        v = vecs[:, -1]
        q = np.array([v[3], v[0], v[1], v[2]])
        return q if q[0] >= 0 else -q

    Ms = []
    for pert in (0.0, 0.1, 0.3, 0.5):
        for _ in range(25):
            k = jax.random.PRNGKey(rs.randint(1 << 30))
            R = np.asarray(_random_rotation(k))
            Ms.append(R + pert * rs.randn(3, 3))
    Ms = np.stack(Ms)
    q_iter = np.asarray(quat.from_rotation_matrix_iter(jnp.asarray(Ms)))
    q_gold = np.stack([np_bar_itzhack(m) for m in Ms])
    err = np.minimum(
        np.abs(q_iter - q_gold).max(-1), np.abs(q_iter + q_gold).max(-1)
    )
    assert err.max() < 1e-9, err.max()
