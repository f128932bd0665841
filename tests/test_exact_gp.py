import numpy as np
import jax
import jax.numpy as jnp
import pytest
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process.kernels import (
    RBF as SkRBF,
    Matern as SkMatern,
    WhiteKernel,
    ConstantKernel as SkC,
)

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models import exact_gp as core
from gaussian_process_transportation_tpu.models import GaussianProcess

rng = np.random.RandomState(42)
N, D, P = 30, 2, 2
X = rng.randn(N, D) * 2
Y = np.stack([np.sin(X[:, 0]) + 0.05 * rng.randn(N), np.cos(X[:, 1])], axis=1)
Xq = rng.randn(12, D) * 2


def make_pair():
    mine = K.Constant(2.0) * K.RBF(jnp.array([1.5, 0.8])) + K.White(0.05)
    sk = SkC(2.0) * SkRBF([1.5, 0.8]) + WhiteKernel(0.05)
    return mine, sk


def test_lml_matches_sklearn():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    lml_sk = gpr.log_marginal_likelihood(sk.theta)
    lml = core.log_marginal_likelihood(mine, jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(float(lml), lml_sk, rtol=1e-10)


def test_lml_grad_matches_sklearn():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    _, grad_sk = gpr.log_marginal_likelihood(sk.theta, eval_gradient=True)
    grad = jax.grad(
        lambda t: core.log_marginal_likelihood(
            mine.with_theta(t), jnp.asarray(X), jnp.asarray(Y)
        )
    )(mine.theta)
    np.testing.assert_allclose(np.asarray(grad), grad_sk, rtol=1e-7, atol=1e-9)


def test_predict_matches_sklearn_fixed_hyperparams():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    mean_sk, std_sk = gpr.predict(Xq, return_std=True)
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    mean, std = core.predict(gp, jnp.asarray(Xq), return_std=True)
    np.testing.assert_allclose(np.asarray(mean), mean_sk, atol=1e-9)
    np.testing.assert_allclose(np.asarray(std), std_sk, atol=1e-8)


def test_predict_cov_matches_sklearn():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    _, cov_sk = gpr.predict(Xq, return_cov=True)
    if cov_sk.ndim == 3:  # sklearn tiles identical cov per target
        cov_sk = cov_sk[..., 0]
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    _, cov = core.predict_cov(gp, jnp.asarray(Xq))
    np.testing.assert_allclose(np.asarray(cov), cov_sk, atol=1e-8)


def test_epistemic_std_convention():
    """Reference subtracts sqrt(noise_level) from the std
    (gaussian_process.py:49)."""
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    _, std_sk = gpr.predict(Xq, return_std=True)
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    _, std = core.predict(gp, jnp.asarray(Xq), return_std=True, epistemic_only=True)
    np.testing.assert_allclose(np.asarray(std), std_sk - np.sqrt(0.05), atol=1e-8)


def _reference_jacobian(gpr, sk_kernel, x, Xtr, Ytr, noise, prior_var, lscale):
    """The reference's broadcasting implementation
    (gaussian_process.py:63-101), re-expressed in numpy for golden values."""
    K_ = sk_kernel(Xtr, Xtr) + (noise + 1e-10) * np.eye(len(Xtr))
    K_inv = np.linalg.inv(K_)
    alfa = K_inv @ Ytr
    k_star = sk_kernel(x, Xtr)
    lscale = np.asarray(lscale).reshape(-1, 1)
    diff = Xtr.T[:, None, :] - x.T[:, :, None]  # (D, Nq, N)
    coeff = diff / (lscale[:, :, None] ** 2)
    dk = coeff * k_star  # (D, Nq, N)
    df = dk.transpose(1, 0, 2) @ alfa  # (Nq, D, P)
    df = df.transpose(0, 2, 1)  # (Nq, P, D)
    dk_Kinv = dk @ K_inv
    diag = np.sum(dk_Kinv * dk, axis=2)  # (D, Nq)
    var = prior_var / (lscale**2) - diag
    var = np.repeat(var[None, :, :], Ytr.shape[1], axis=0).transpose(2, 0, 1)
    return df, var


def test_jacobian_matches_reference_formula():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(kernel=sk, alpha=1e-10, optimizer=None)
    gpr.fit(X, Y)
    df_ref, var_ref = _reference_jacobian(
        gpr, sk, Xq, X, Y, noise=0.05, prior_var=2.0, lscale=[1.5, 0.8]
    )
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    df, var = core.jacobian(gp, jnp.asarray(Xq), return_var=True)
    np.testing.assert_allclose(np.asarray(df), df_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var), var_ref, atol=1e-8)


def test_jacobian_mean_matches_finite_difference():
    mine, _ = make_pair()
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    df = core.jacobian(gp, jnp.asarray(Xq))
    eps = 1e-6
    for d in range(D):
        dx = np.zeros(D)
        dx[d] = eps
        up = core.predict(gp, jnp.asarray(Xq + dx))
        dn = core.predict(gp, jnp.asarray(Xq - dx))
        fd = (np.asarray(up) - np.asarray(dn)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(df[:, :, d]), fd, atol=1e-5)


def test_variance_gradient_matches_finite_difference():
    mine, _ = make_pair()
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    dvar = core.variance_gradient(gp, jnp.asarray(Xq))

    def var_at(xs):
        k_star = np.asarray(gp.kernel(jnp.asarray(xs), gp.X))
        Kinv = np.asarray(core.cho_solve_lower(gp.L, jnp.eye(len(np.asarray(gp.X)))))
        return -np.einsum("qn,nm,qm->q", k_star, Kinv, k_star)

    eps = 1e-6
    for d in range(D):
        dx = np.zeros(D)
        dx[d] = eps
        fd = (var_at(Xq + dx) - var_at(Xq - dx)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(dvar[:, d]), fd, atol=1e-4)


def test_fit_reaches_sklearn_quality():
    """Hyperopt parity gate: our fitted LML must be >= sklearn's (within
    tolerance), and posteriors must agree closely on the data support."""
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(
        kernel=sk, alpha=1e-10, n_restarts_optimizer=3, random_state=0
    )
    gpr.fit(X, Y)
    lml_sk = gpr.log_marginal_likelihood(gpr.kernel_.theta)

    gp = core.fit(mine, jnp.asarray(X), jnp.asarray(Y), n_restarts=3)
    lml = float(core.log_marginal_likelihood(gp.kernel, gp.X, gp.Y))
    assert lml >= lml_sk - 1e-3, (lml, lml_sk)

    mean_sk, std_sk = gpr.predict(Xq, return_std=True)
    mean, std = core.predict(gp, jnp.asarray(Xq), return_std=True)
    scale = np.abs(mean_sk).max()
    np.testing.assert_allclose(np.asarray(mean), mean_sk, atol=2e-3 * scale + 1e-4)


@pytest.mark.slow
def test_fit_jit_reaches_sklearn_quality():
    mine, sk = make_pair()
    gpr = GaussianProcessRegressor(
        kernel=sk, alpha=1e-10, n_restarts_optimizer=3, random_state=0
    )
    gpr.fit(X, Y)
    lml_sk = gpr.log_marginal_likelihood(gpr.kernel_.theta)
    gp = core.fit_jit(mine, jnp.asarray(X), jnp.asarray(Y), n_restarts=3, maxiter=150)
    lml = float(core.log_marginal_likelihood(gp.kernel, gp.X, gp.Y))
    assert lml >= lml_sk - 0.5, (lml, lml_sk)


def test_nan_row_filtering():
    Yn = Y.copy()
    Yn[3, 0] = np.nan
    Yn[17, 1] = np.nan
    model = GaussianProcess(K.Constant(2.0) * K.RBF(jnp.ones(2)) + K.White(0.05), optimizer=None)
    model.fit(X, Yn)
    assert model.state.X.shape[0] == N - 2


def test_sample_y_statistics():
    mine, _ = make_pair()
    gp = core.condition(mine, jnp.asarray(X), jnp.asarray(Y))
    s = core.sample_y(gp, jnp.asarray(Xq), jax.random.PRNGKey(0), n_samples=4000)
    assert s.shape == (4000, len(Xq), P)
    mean, std = core.predict(gp, jnp.asarray(Xq), return_std=True)
    np.testing.assert_allclose(np.asarray(s.mean(0)), np.asarray(mean), atol=0.06)
    np.testing.assert_allclose(np.asarray(s.std(0)), np.asarray(std), atol=0.06)


def test_vmapped_conditioning():
    """An ensemble of GPs = one batched conditioning (the unit of data
    parallelism, replacing the reference's Python ensemble loops)."""
    mine, _ = make_pair()
    Ys = jnp.asarray(np.stack([Y + 0.1 * i for i in range(5)]))
    gps = jax.vmap(lambda y: core.condition(mine, jnp.asarray(X), y))(Ys)
    means = jax.vmap(lambda g: core.predict(g, jnp.asarray(Xq)))(gps)
    assert means.shape == (5, len(Xq), P)
    single = core.predict(core.condition(mine, jnp.asarray(X), Ys[3]), jnp.asarray(Xq))
    np.testing.assert_allclose(np.asarray(means[3]), np.asarray(single), atol=1e-10)


@pytest.mark.slow
def test_lml_small_analytic_gradient_matches_ad():
    """The small-N LML (custom VJP, ensemble-last Cholesky under vmap) must
    match the plain Cholesky+autodiff path in value and in gradients w.r.t.
    kernel theta, X, and Y — unbatched and vmapped."""
    import math

    from gaussian_process_transportation_tpu.ops.linalg import (
        add_diagonal,
        cho_solve_lower,
        log_det_from_chol,
    )

    rng2 = np.random.RandomState(4)
    X = jnp.asarray(rng2.randn(17, 2))
    Y = jnp.asarray(rng2.randn(17, 2))
    kern = K.Constant(2.0) * K.RBF(jnp.asarray([0.8, 1.4])) + K.White(0.05)

    def lml_ref(theta, Xv, Yv):
        k = kern.with_theta(theta)
        Km = add_diagonal(k(Xv), 1e-10)
        L = jnp.linalg.cholesky(Km)
        alpha = cho_solve_lower(L, Yv)
        return -0.5 * jnp.sum(Yv * alpha) - Yv.shape[1] * (
            0.5 * log_det_from_chol(L) + 0.5 * Xv.shape[0] * math.log(2 * math.pi)
        )

    def lml_new(theta, Xv, Yv):
        return core.log_marginal_likelihood(kern.with_theta(theta), Xv, Yv, 1e-10)

    th = kern.theta
    np.testing.assert_allclose(float(lml_ref(th, X, Y)), float(lml_new(th, X, Y)), rtol=1e-12)
    g_ref = jax.grad(lml_ref, argnums=(0, 1, 2))(th, X, Y)
    g_new = jax.grad(lml_new, argnums=(0, 1, 2))(th, X, Y)
    for a, b in zip(g_ref, g_new):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-10)

    ths = jnp.stack([th, th + 0.1, th * 1.3])
    gv_ref = jax.vmap(jax.grad(lambda t: lml_ref(t, X, Y)))(ths)
    gv_new = jax.jit(jax.vmap(jax.grad(lambda t: lml_new(t, X, Y))))(ths)
    np.testing.assert_allclose(np.asarray(gv_ref), np.asarray(gv_new), rtol=1e-8, atol=1e-10)
