"""Dense-grid GP prediction through plain XLA (``models.exact_gp.predict``)
against float64 numpy, over the RBF and Matérn families.

The reference evaluates posterior means and uncertainty fields on
100×100 grids (``plot_utils.py:10-24, 181-207``); on the GPU XLA fuses the
kernel evaluation into the cross-covariance GEMM, so these paths need no
hand-written kernel.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models import exact_gp as core

rng = np.random.RandomState(12)

_F32 = jnp.float32


def _k_np(A, B, ls, amp, family="rbf"):
    d2 = (((A[:, None, :] - B[None, :, :]) / ls) ** 2).sum(-1)
    if family == "rbf":
        return amp * np.exp(-0.5 * d2)
    r = np.sqrt(d2)
    if family == "matern32":
        return amp * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)
    return amp * (1 + np.sqrt(5) * r + 5 * d2 / 3) * np.exp(-np.sqrt(5) * r)


def _kernel(family, ls, amp, noise=0.05):
    base = K.RBF(jnp.asarray(ls, _F32)) if family == "rbf" else K.Matern(
        jnp.asarray(ls, _F32), nu={"matern32": 1.5, "matern52": 2.5}[family])
    return K.Constant(amp) * base + K.White(noise)


def test_rbf_gram_matches_reference_kernel():
    X = rng.randn(50, 2)
    Z = rng.randn(37, 2)
    ls = np.array([1.5, 0.7])
    got = np.asarray(_kernel("rbf", ls, 2.5)(jnp.asarray(X, _F32), jnp.asarray(Z, _F32)))
    np.testing.assert_allclose(got, _k_np(X, Z, ls, 2.5), atol=1e-5)


def test_stationary_gram_matern_matches_kernel():
    X = rng.randn(50, 2)
    Z = rng.randn(37, 2)
    ls = np.array([1.5, 0.7])
    got = np.asarray(
        _kernel("matern52", ls, 2.5)(jnp.asarray(X, _F32), jnp.asarray(Z, _F32))
    )
    np.testing.assert_allclose(got, _k_np(X, Z, ls, 2.5, "matern52"), atol=1e-5)


def _gp_with_alpha(family, X, alpha, ls, amp):
    return core.ExactGP(
        kernel=_kernel(family, ls, amp), X=jnp.asarray(X, _F32),
        Y=jnp.zeros(alpha.shape, _F32), alpha=jnp.asarray(alpha, _F32),
    )


def test_fused_predict_mean_matches_dense():
    """Posterior mean k(X*, X)·α for a given α, float32 vs float64."""
    N, Nq, D, P = 90, 70, 2, 2
    X, Xq, alpha = rng.randn(N, D), rng.randn(Nq, D), rng.randn(N, P)
    ls, amp = np.array([1.0, 2.0]), 3.0
    got = np.asarray(jax.jit(core.predict)(
        _gp_with_alpha("rbf", X, alpha, ls, amp), jnp.asarray(Xq, _F32)))
    np.testing.assert_allclose(got, _k_np(Xq, X, ls, amp) @ alpha, atol=1e-4)


@pytest.mark.parametrize("family", ["matern32", "matern52"])
def test_fused_predict_mean_matern_matches_dense(family):
    N, Nq, D, P = 90, 70, 2, 2
    X, Xq, alpha = rng.randn(N, D), rng.randn(Nq, D), rng.randn(N, P)
    ls, amp = np.array([1.0, 2.0]), 3.0
    got = np.asarray(jax.jit(core.predict)(
        _gp_with_alpha(family, X, alpha, ls, amp), jnp.asarray(Xq, _F32)))
    np.testing.assert_allclose(
        got, _k_np(Xq, X, ls, amp, family) @ alpha, atol=1e-4)


def test_fused_predict_mean_agrees_with_exact_gp():
    """End to end: condition in float32 then predict, vs a float64 solve."""
    N, D = 60, 2
    X = rng.randn(N, D)
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1)
    Xq = rng.randn(25, D)
    ls, amp, noise = np.array([1.0, 1.0]), 2.0, 0.05
    gp = core.condition(_kernel("rbf", ls, amp, noise), jnp.asarray(X, _F32),
                        jnp.asarray(Y, _F32))
    got = np.asarray(core.predict(gp, jnp.asarray(Xq, _F32)))
    Km = _k_np(X, X, ls, amp) + (noise + core._eff_jitter(_F32, 1e-10)) * np.eye(N)
    np.testing.assert_allclose(
        got, _k_np(Xq, X, ls, amp) @ np.linalg.solve(Km, Y), atol=2e-4)


@pytest.mark.parametrize("family", ["rbf", "matern52"])
def test_fused_predict_mean_var_matches_exact_gp(family):
    """Mean and std on a grid, both variance routes (triangular solve and
    cached K⁻¹), float32 vs float64."""
    N, D = 60, 2
    X = rng.randn(N, D)
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1)
    Xq = rng.randn(41, D)
    ls, amp, noise = np.array([1.0, 1.5]), 2.0, 0.05
    kern = _kernel(family, ls, amp, noise)
    Km = _k_np(X, X, ls, amp, family) + (
        noise + core._eff_jitter(_F32, 1e-10)) * np.eye(N)
    ks = _k_np(Xq, X, ls, amp, family)
    mean64 = ks @ np.linalg.solve(Km, Y)
    std64 = np.sqrt((amp + noise) - np.einsum("qn,qn->q", ks @ np.linalg.inv(Km), ks))
    for cache in (False, True):
        gp = core.condition(kern, jnp.asarray(X, _F32), jnp.asarray(Y, _F32),
                            cache_k_inv=cache)
        mean, std = core.predict(gp, jnp.asarray(Xq, _F32), return_std=True)
        np.testing.assert_allclose(np.asarray(mean), mean64, atol=3e-4)
        np.testing.assert_allclose(np.asarray(std)[:, 0], std64, atol=3e-4)


def test_predict_routes_matern_family_params():
    """stationary_family_params recognizes the reference's canonical
    C*Matern(2.5)+White policy-DS kernel (surface_generalization.py:49)."""
    kern = K.Constant(0.1) * K.Matern(jnp.asarray([0.3, 0.3]), nu=2.5) + K.White(0.0001)
    params = core.stationary_family_params(kern)
    assert params is not None
    fam, amp, ls = params
    assert fam == "matern52"
    np.testing.assert_allclose(float(amp), 0.1)
    np.testing.assert_allclose(np.asarray(ls), [0.3, 0.3])
    # RBF still reports rbf; unsupported kernels return None
    assert core.stationary_family_params(K.RBF(1.0))[0] == "rbf"
    assert core.stationary_family_params(K.RBF(1.0) * K.RBF(2.0)) is None
