"""Obstacle-avoidance modulation: geometric invariants + golden checks
against the reference's formulas (obstacle_avoidance_Linear_DS.py,
plot_utils.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu.avoidance import (
    Obstacles,
    gamma,
    modulation_bases,
    obstacle_weights,
    directional_weighted_sum,
    modulation_matrix_spherical,
    modulation_matrix_elliptic,
    modulate_multiple,
    avoid,
    rollout,
)

rng = np.random.RandomState(2)


def circle_obstacle(center=(0.0, 0.0), radius=2.0):
    return Obstacles.from_dicts(
        [
            {
                "shape": "ellipse",
                "center": np.asarray(center, float),
                "reference_point": np.zeros(2),
                "axis_length": np.array([2 * radius, 2 * radius]),
                "orientation": 0,
                "margin": 0.0,
                "repulsion_coeff": 1.0,
                "linear_velocity": np.zeros(2),
                "angular_velocity": None,
            }
        ]
    )


def test_gamma_circle_analytic():
    """For a circle of radius r: Γ = |x| − r + 1 outside."""
    obs = circle_obstacle(radius=2.0)
    pts = np.array([[4.0, 0.0], [0.0, 3.0], [5.0, 5.0]])
    g = np.asarray(gamma(obs, jnp.asarray(pts)))[0]
    expected = np.linalg.norm(pts, axis=1) - 2.0 + 1.0
    np.testing.assert_allclose(g, expected, atol=1e-9)
    # inside: Γ = |x|/r < 1  (reference: distance_zeta/distance_surface − 1 + 1)
    inside = np.array([[1.0, 0.0]])
    gi = np.asarray(gamma(obs, jnp.asarray(inside)))[0]
    np.testing.assert_allclose(gi, 0.5, atol=1e-9)


def test_gamma_cuboid_outside():
    obs = Obstacles.from_dicts(
        [
            {
                "shape": "cuboid",
                "center": np.zeros(2),
                "axis_length": np.array([2.0, 2.0]),
                "orientation": 0,
                "margin": 0.0,
            }
        ]
    )
    pts = np.array([[3.0, 0.0], [0.0, 4.0]])
    g = np.asarray(gamma(obs, jnp.asarray(pts)))[0]
    np.testing.assert_allclose(g, [3.0, 4.0], atol=1e-9)  # face dist + 1


def test_obstacle_weights_normalize_and_saturate():
    obs = Obstacles.from_dicts(
        [
            {"shape": "ellipse", "center": np.array([0.0, 0.0]), "axis_length": np.array([2.0, 2.0])},
            {"shape": "ellipse", "center": np.array([10.0, 0.0]), "axis_length": np.array([2.0, 2.0])},
        ]
    )
    pts = np.array([[1.2, 0.0], [5.0, 0.0], [8.9, 0.0]])
    g = gamma(obs, jnp.asarray(pts))
    w = np.asarray(obstacle_weights(g))
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-9)
    assert w[0, 0] > 0.95  # near obstacle 0 → its weight dominates
    assert w[1, 2] > 0.95


def test_spherical_modulation_impermeability():
    """At the boundary, M v has no radial (outward-normal) component —
    λ₁ = 1 − (r/d)² → 0."""
    center = jnp.zeros(2)
    r = 2.0
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    boundary = (r + 1e-9) * np.stack([np.cos(theta), np.sin(theta)], 1)
    M = modulation_matrix_spherical(jnp.asarray(boundary), center, r)
    v = jnp.asarray(rng.randn(16, 2))
    out = (M @ v[:, :, None])[:, :, 0]
    radial = np.sum(np.asarray(out) * boundary / r, axis=1)
    np.testing.assert_allclose(radial, 0.0, atol=1e-6)


def test_spherical_modulation_far_field_identity():
    M = modulation_matrix_spherical(jnp.asarray([[500.0, 0.0]]), jnp.zeros(2), 2.0)
    np.testing.assert_allclose(np.asarray(M[0]), np.eye(2), atol=1e-4)


def test_elliptic_modulation_matches_reference_formula():
    """Golden check vs the reference implementation (plot_utils.py:135-161)."""
    center = np.array([[1.0], [2.0]])
    r1, r2, m = 3.0, 2.0, 4

    def ref(state):
        M = np.zeros((state.shape[0], 2, 2))
        q = state.T - center
        gx = (m / r1**m) * np.power(q[[0], :], m - 1)
        gy = (m / r2**m) * np.power(q[[1], :], m - 1)
        grad = np.append(gx, gy, axis=0)
        for i in range(state.shape[0]):
            n = grad[:, [i]]
            e = np.cross(np.vstack((n, [0])).reshape(-1), np.array([0, 0, 1]))
            E = np.hstack((n, e[0:2].reshape(n.shape)))
            d = (q[0, i] / r1) ** m + (q[1, i] / r2) ** m
            D = np.diag([1 - 1 / abs(d), 1 + 1 / abs(d)])
            M[i] = E @ D @ np.linalg.inv(E)
        return M

    state = rng.randn(10, 2) * 5 + np.array([6.0, 6.0])
    expected = ref(state)
    got = np.asarray(
        modulation_matrix_elliptic(jnp.asarray(state), jnp.asarray(center.ravel()), r1, r2, m)
    )
    np.testing.assert_allclose(got, expected, atol=1e-8)


def test_multi_obstacle_modulation_impermeability():
    obs = circle_obstacle(radius=2.0)
    theta = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    boundary = 2.000001 * np.stack([np.cos(theta), np.sin(theta)], 1)
    M = modulate_multiple(obs, jnp.asarray(boundary))
    v = jnp.asarray(rng.randn(12, 2))
    out = (M @ v[:, :, None])[:, :, 0]
    radial = np.sum(np.asarray(out) * boundary / 2.0, axis=1)
    np.testing.assert_allclose(radial, 0.0, atol=1e-5)


def test_avoid_far_field_identity():
    obs = circle_obstacle(radius=2.0)
    x = jnp.asarray([[3000.0, 1000.0]])  # modulation decays as 1/Γ
    v = jnp.asarray([[1.0, -0.5]])
    out = np.asarray(avoid(obs, x, v))
    np.testing.assert_allclose(out, np.asarray(v), atol=1e-3)


def test_avoid_deflects_head_on():
    obs = circle_obstacle(center=(5.0, 0.0), radius=1.5)
    x = jnp.asarray([[2.0, 0.01]])
    v = jnp.asarray([[1.0, 0.0]])
    out = np.asarray(avoid(obs, x, v))[0]
    assert abs(out[1]) > 1e-3  # deflected off the collision course
    assert np.isfinite(out).all()


def test_rollout_avoids_obstacle():
    """Linear DS toward a goal with one obstacle in between: the rolled-out
    trajectory must not penetrate the obstacle."""
    obs = circle_obstacle(center=(5.0, 0.0), radius=1.5)
    goal = jnp.asarray([10.0, 0.0])

    def velocity_fn(x):
        return 0.15 * (goal[None, :] - x)

    def modulation_fn(x):
        return modulate_multiple(obs, x)

    x0 = jnp.asarray([[0.0, 0.3]])
    traj = np.asarray(rollout(velocity_fn, modulation_fn, x0, n_steps=150))
    d = np.linalg.norm(traj[:, 0, :] - np.array([5.0, 0.0]), axis=1)
    assert d.min() > 1.35, d.min()  # stays (numerically) outside
    assert np.linalg.norm(traj[-1, 0] - np.array([10.0, 0.0])) < 0.5  # reaches goal


def test_directional_weighted_sum_basics():
    null = jnp.asarray([1.0, 0.0])
    # single full-weight direction → returned unchanged
    d = jnp.asarray([[0.0], [1.0]])
    out = np.asarray(directional_weighted_sum(null, d, jnp.asarray([1.0])))
    np.testing.assert_allclose(out, [0.0, 1.0], atol=1e-9)
    # symmetric ±45° with equal weights → null direction
    dirs = jnp.asarray(np.stack([[np.cos(0.7), np.sin(0.7)], [np.cos(-0.7), np.sin(-0.7)]], axis=1))
    out = np.asarray(directional_weighted_sum(null, dirs, jnp.asarray([0.5, 0.5])))
    np.testing.assert_allclose(out, [1.0, 0.0], atol=1e-9)


def test_directional_weighted_sum_3d():
    null = jnp.asarray([0.0, 0.0, 1.0])
    dirs = jnp.asarray([[1.0, -1.0], [0.0, 0.0], [0.0, 0.0]])
    out = np.asarray(directional_weighted_sum(null, dirs, jnp.asarray([0.5, 0.5])))
    np.testing.assert_allclose(out, [0.0, 0.0, 1.0], atol=1e-9)


def test_batched_rollout_many_agents():
    """50-agent rollout (the reference's dynamic_modulation_2019.py demo)
    as one program."""
    obs = circle_obstacle(center=(5.0, 0.0), radius=1.5)
    goal = jnp.asarray([10.0, 0.0])
    x0 = jnp.asarray(np.stack([np.zeros(50), np.linspace(-3, 3, 50)], axis=1))
    traj = rollout(
        lambda x: 0.2 * (goal[None] - x),
        lambda x: modulate_multiple(obs, x),
        x0,
        n_steps=100,
    )
    assert traj.shape == (100, 50, 2)
    d = np.linalg.norm(np.asarray(traj) - np.array([5.0, 0.0]), axis=2)
    assert d.min() > 1.3


# ---------------------------------------------------------------------------
# n-D directional algebra
# ---------------------------------------------------------------------------

import pytest as _pytest
from gaussian_process_transportation_tpu.avoidance.directional import (
    angle_from_vector,
    invert_normal,
    orthogonal_basis,
    transform_to_base,
    vector_from_angle,
)


@_pytest.mark.parametrize("D", [2, 3, 4, 5, 8])
def test_orthogonal_basis_nd_is_orthonormal(D):
    rng2 = np.random.RandomState(3 + D)
    for _ in range(5):
        v = rng2.randn(D)
        B = np.asarray(orthogonal_basis(jnp.asarray(v)))
        assert np.allclose(B.T @ B, np.eye(D), atol=1e-9)
        assert np.allclose(B[:, 0], v / np.linalg.norm(v), atol=1e-9)


@_pytest.mark.parametrize("D", [2, 3, 5, 8])
def test_angle_vector_roundtrip_nd(D):
    rng2 = np.random.RandomState(11 + D)
    base = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
    for _ in range(6):
        d = rng2.randn(D)
        d = d / np.linalg.norm(d)
        a = angle_from_vector(jnp.asarray(d), jnp.asarray(base))
        v = np.asarray(vector_from_angle(a, jnp.asarray(base)))
        assert np.allclose(v, d, atol=1e-6)


@_pytest.mark.parametrize("D", [2, 3, 5])
def test_invert_normal_roundtrips_through_negated_base(D):
    rng2 = np.random.RandomState(17 + D)
    base = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
    for _ in range(6):
        d = rng2.randn(D)
        d = d / np.linalg.norm(d)
        a = angle_from_vector(jnp.asarray(d), jnp.asarray(base))
        a_inv = invert_normal(a)
        v = np.asarray(vector_from_angle(a_inv, jnp.asarray(-base)))
        assert np.allclose(v, d, atol=1e-6)
        # |a| + |a'| = pi (the two representations straddle the equator)
        assert np.isclose(float(jnp.linalg.norm(a)) + float(jnp.linalg.norm(a_inv)), np.pi, atol=1e-6)


@_pytest.mark.parametrize("D", [3, 5])
def test_transform_to_base_preserves_vector(D):
    rng2 = np.random.RandomState(23 + D)
    b1 = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
    b2 = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
    d = rng2.randn(D)
    d = d / np.linalg.norm(d)
    a1 = angle_from_vector(jnp.asarray(d), jnp.asarray(b1))
    a2 = transform_to_base(a1, jnp.asarray(b1), jnp.asarray(b2))
    v = np.asarray(vector_from_angle(a2, jnp.asarray(b2)))
    assert np.allclose(v, d, atol=1e-6)


@_pytest.mark.parametrize("D", [3, 5])
def test_transform_to_base_windup_same_direction(D):
    """track_windup=True may only change the 2π chart, never the direction
    represented (exp map is 2π-periodic in |a|), and when no cut is crossed
    it must equal the principal result (obs_utils.py:302-346 intent)."""
    rng2 = np.random.RandomState(41 + D)
    for trial in range(20):
        b1 = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
        b2 = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
        d = rng2.randn(D)
        d = d / np.linalg.norm(d)
        a1 = angle_from_vector(jnp.asarray(d), jnp.asarray(b1))
        a_plain = transform_to_base(a1, jnp.asarray(b1), jnp.asarray(b2))
        a_wind = transform_to_base(
            a1, jnp.asarray(b1), jnp.asarray(b2), track_windup=True
        )
        v_plain = np.asarray(vector_from_angle(a_plain, jnp.asarray(b2)))
        v_wind = np.asarray(vector_from_angle(a_wind, jnp.asarray(b2)))
        assert np.allclose(v_plain, d, atol=1e-6)
        assert np.allclose(v_wind, d, atol=1e-5)
        # windup differs from principal only by 2π·k along the angle direction
        diff = float(np.linalg.norm(np.asarray(a_wind) - np.asarray(a_plain)))
        k = diff / (2 * np.pi)
        assert abs(k - round(k)) < 1e-5


def test_transform_to_base_windup_near_cut_stays_close_to_normal_image():
    """Crossing the ±π cut: the wound representation lands within π of the
    old normal's image (continuity chart), where the principal one jumps."""
    rng2 = np.random.RandomState(7)
    D = 3
    b1 = np.asarray(orthogonal_basis(jnp.asarray(rng2.randn(D))))
    # direction almost antipodal to the NEW base's normal → principal angle
    # near the ±π cut
    n2_dir = rng2.randn(D)
    b2 = np.asarray(orthogonal_basis(jnp.asarray(n2_dir)))
    d = -b2[:, 0] + 0.05 * b2[:, 1]
    d = d / np.linalg.norm(d)
    a1 = angle_from_vector(jnp.asarray(d), jnp.asarray(b1))
    a_wind = transform_to_base(
        a1, jnp.asarray(b1), jnp.asarray(b2), track_windup=True
    )
    # whatever chart it picks, it must still represent d
    v = np.asarray(vector_from_angle(a_wind, jnp.asarray(b2)))
    assert np.allclose(v, d, atol=1e-5)


@_pytest.mark.parametrize("D", [4, 6])
def test_directional_weighted_sum_nd_vs_numpy(D):
    """Inline numpy re-implementation of the reference algorithm
    (obs_utils.py:420-476) in general D, using the same basis."""
    rng2 = np.random.RandomState(31 + D)
    null = rng2.randn(D)
    K = 4
    dirs = rng2.randn(D, K)
    w = np.abs(rng2.rand(K))
    base = np.asarray(orthogonal_basis(jnp.asarray(null)))

    n, Bt = base[:, 0], base[:, 1:]
    a_sum = np.zeros(D - 1)
    for k in range(K):
        dk = dirs[:, k] / np.linalg.norm(dirs[:, k])
        phi = np.arccos(np.clip(dk @ n, -1, 1))
        t = Bt.T @ dk
        tn = np.linalg.norm(t)
        t_hat = t / tn if tn > 1e-12 else np.zeros(D - 1)
        a_sum = a_sum + w[k] * phi * t_hat
    an = np.linalg.norm(a_sum)
    expected = np.cos(an) * n + (np.sin(an) * (Bt @ (a_sum / an)) if an > 1e-12 else 0.0)

    out = np.asarray(directional_weighted_sum(jnp.asarray(null), jnp.asarray(dirs), jnp.asarray(w)))
    assert np.allclose(out, expected, atol=1e-8)
