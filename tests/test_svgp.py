"""SVGP tests, modeled on the reference's manual check scripts
(test/svgp_derivatives.py — 1-D cos; test/svgp_derivatives_mimo.py —
2-task cos/sin), but with numeric assertions instead of visual checks.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models import svgp
from gaussian_process_transportation_tpu.models import exact_gp as core

rng = np.random.RandomState(0)


@pytest.fixture(scope="module")
def cos_sin_model():
    N = 300
    X = np.linspace(0, 2 * np.pi, N)[:, None]
    Y = np.stack([np.cos(X[:, 0]), np.sin(X[:, 0])], axis=1) + 0.05 * rng.randn(N, 2)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(1))
    state = svgp.fit(
        kernel,
        jnp.asarray(X),
        jnp.asarray(Y),
        num_inducing=30,
        num_epochs=300,
        batch_size=100,
        learning_rate=0.05,
        key=jax.random.PRNGKey(0),
    )
    return X, Y, state


@pytest.mark.slow
def test_svgp_posterior_accuracy(cos_sin_model):
    X, Y, state = cos_sin_model
    c = svgp.collapse(state)
    xq = np.linspace(0.3, 2 * np.pi - 0.3, 50)[:, None]
    mean, std = svgp.posterior_f(c, jnp.asarray(xq))
    truth = np.stack([np.cos(xq[:, 0]), np.sin(xq[:, 0])], axis=1)
    assert mean.shape == (50, 2) and std.shape == (50, 2)
    rmse = np.sqrt(np.mean((np.asarray(mean) - truth) ** 2))
    assert rmse < 0.08, rmse
    assert np.all(np.asarray(std) >= 0)


def test_svgp_derivative_posterior(cos_sin_model):
    """f = (cos, sin) ⇒ f' = (−sin, cos): the reference's visual check
    (test/svgp_derivatives_mimo.py), asserted numerically."""
    X, Y, state = cos_sin_model
    c = svgp.collapse(state)
    xq = np.linspace(0.5, 2 * np.pi - 0.5, 40)[:, None]
    dmean, dstd = svgp.posterior_f_prime(c, jnp.asarray(xq))
    assert dmean.shape == (40, 2, 1) and dstd.shape == (40, 2, 1)
    truth = np.stack([-np.sin(xq[:, 0]), np.cos(xq[:, 0])], axis=1)[:, :, None]
    rmse = np.sqrt(np.mean((np.asarray(dmean) - truth) ** 2))
    assert rmse < 0.15, rmse
    assert np.all(np.asarray(dstd) >= 0)


def test_collapse_consistency_with_variational_predictive(cos_sin_model):
    """The collapsed exact-GP form must reproduce the variational
    predictive q(f*) = N(k*K⁻¹m, k** − k*K⁻¹(K−S)K⁻¹k*) computed directly."""
    X, Y, state = cos_sin_model
    c = svgp.collapse(state)
    xq = jnp.asarray(np.linspace(1.0, 5.0, 7)[:, None])
    mean, std = svgp.posterior_f(c, xq)

    p = state.params
    t = 0
    k = state.kernel.with_theta(p.theta[t])
    Kmm = np.asarray(k(p.Z[t])) + state.jitter * np.eye(p.Z[t].shape[0])
    Lk = np.linalg.cholesky(Kmm)
    Lw = np.asarray(svgp._tril_with_softplus_diag(p.L_w_raw[t]))
    m_u = Lk @ np.asarray(p.m_w[t])
    S_u = Lk @ (Lw @ Lw.T) @ Lk.T
    Kinv = np.linalg.inv(Kmm)
    ks = np.asarray(k(xq, p.Z[t]))
    mean_direct = ks @ Kinv @ m_u
    cov_direct = np.asarray(k(xq)) - ks @ Kinv @ (Kmm - S_u) @ Kinv @ ks.T
    np.testing.assert_allclose(np.asarray(mean[:, t]), mean_direct, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(std[:, t]), np.sqrt(np.clip(np.diag(cov_direct), 0, None)), atol=1e-5
    )


def test_derivative_mean_matches_finite_difference(cos_sin_model):
    X, Y, state = cos_sin_model
    c = svgp.collapse(state)
    xq = np.linspace(1.0, 5.0, 9)[:, None]
    dmean, _ = svgp.posterior_f_prime(c, jnp.asarray(xq))
    eps = 1e-5
    up, _ = svgp.posterior_f(c, jnp.asarray(xq + eps))
    dn, _ = svgp.posterior_f(c, jnp.asarray(xq - eps))
    fd = (np.asarray(up) - np.asarray(dn)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(dmean[:, :, 0]), fd, atol=1e-4)


@pytest.mark.slow
def test_elbo_increases_during_training():
    N = 200
    X = np.linspace(0, 2 * np.pi, N)[:, None]
    Y = np.cos(X)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(1))
    key = jax.random.PRNGKey(1)
    p0 = svgp.init_params(kernel, jnp.asarray(X), jnp.asarray(Y), 20, key)
    e0 = float(svgp.elbo(kernel, p0, jnp.asarray(X), jnp.asarray(Y), N, 1e-6))
    state = svgp.fit(
        kernel, jnp.asarray(X), jnp.asarray(Y),
        num_inducing=20, num_epochs=100, batch_size=64, learning_rate=0.05, key=key,
    )
    e1 = float(svgp.elbo(kernel, state.params, jnp.asarray(X), jnp.asarray(Y), N, 1e-6))
    assert e1 > e0, (e0, e1)


@pytest.mark.slow
def test_wrapper_interface():
    N = 150
    X = rng.randn(N, 2)
    Y = np.stack([X[:, 0] ** 2, X[:, 1]], axis=1)
    m = svgp.StochasticVariationalGaussianProcess(X, Y, num_inducing=40)
    m.fit(num_epochs=60, batch_size=64)
    xq = rng.randn(8, 2)
    mean, std = m.predict(xq, return_std=True)
    assert mean.shape == (8, 2) and std.shape == (8, 2)
    J, Jvar = m.derivative(xq, return_var=True)
    assert J.shape == (8, 2, 2) and Jvar.shape == (8, 2, 2)
    s = m.samples(xq, n_samples=5)
    assert s.shape == (5, 8, 2)


def test_natgrad_converges_faster_per_pass():
    """Natural-gradient variational updates must reach a better ELBO than
    Adam-only in the same (small) number of epochs."""
    N = 300
    X = np.linspace(0, 2 * np.pi, N)[:, None]
    Y = np.stack([np.cos(X[:, 0]), np.sin(X[:, 0])], axis=1) + 0.05 * rng.randn(N, 2)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(1))
    common = dict(num_inducing=30, num_epochs=10, batch_size=100, key=jax.random.PRNGKey(0))
    s_adam = svgp.fit(kernel, jnp.asarray(X), jnp.asarray(Y), learning_rate=0.05, **common)
    s_nat = svgp.fit_natgrad(kernel, jnp.asarray(X), jnp.asarray(Y), learning_rate=0.05, **common)
    e_adam = float(svgp.elbo(kernel, s_adam.params, jnp.asarray(X), jnp.asarray(Y), N, 1e-6))
    e_nat = float(svgp.elbo(kernel, s_nat.params, jnp.asarray(X), jnp.asarray(Y), N, 1e-6))
    assert e_nat > e_adam, (e_nat, e_adam)
    # and the collapsed posterior is accurate
    c = svgp.collapse(s_nat)
    xq = np.linspace(0.3, 2 * np.pi - 0.3, 40)[:, None]
    mean, std = svgp.posterior_f(c, jnp.asarray(xq))
    truth = np.stack([np.cos(xq[:, 0]), np.sin(xq[:, 0])], axis=1)
    assert np.sqrt(np.mean((np.asarray(mean) - truth) ** 2)) < 0.1
    assert np.isfinite(np.asarray(std)).all()


@pytest.mark.slow
def test_natgrad_collapsed_posterior_matches_adam_converged():
    """On a converged run the two optimizers must agree —
    the natural-gradient path's collapsed posterior is the same posterior,
    not merely a better ELBO."""
    N = 300
    X = np.linspace(0, 2 * np.pi, N)[:, None]
    Y = np.stack([np.cos(X[:, 0]), np.sin(X[:, 0])], axis=1) + 0.05 * rng.randn(N, 2)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(1))
    common = dict(num_inducing=30, batch_size=100, key=jax.random.PRNGKey(0))
    s_adam = svgp.fit(kernel, jnp.asarray(X), jnp.asarray(Y),
                      num_epochs=400, learning_rate=0.05, **common)
    s_nat = svgp.fit_natgrad(kernel, jnp.asarray(X), jnp.asarray(Y),
                             num_epochs=60, learning_rate=0.05, **common)
    xq = np.linspace(0.3, 2 * np.pi - 0.3, 50)[:, None]
    m_adam, sd_adam = svgp.posterior_f(svgp.collapse(s_adam), jnp.asarray(xq))
    m_nat, sd_nat = svgp.posterior_f(svgp.collapse(s_nat), jnp.asarray(xq))
    scale = float(np.abs(np.asarray(m_adam)).max())
    assert np.abs(np.asarray(m_nat) - np.asarray(m_adam)).max() < 0.12 * scale
    # predictive stds agree to the same order (both small, well-fit data)
    assert float(np.abs(np.asarray(sd_nat) - np.asarray(sd_adam)).max()) < 0.1
