"""Gaussian mixture regression (GMR) delta map.

Parity with the reference's GMM transport demo
(``example/comparisons/surfaces/surface_generalization_with_gmm.py:62-67``),
which fits ``gmr.sklearn.GaussianMixtureRegressor(n_components=10)`` on the
affine-aligned source → target pairs and maps the trajectory through the
conditional mean.  Here both halves are jitted JAX:

* the joint GMM over Z = [X, Y] is fit by a fully jitted EM
  (``lax.scan`` over iterations, batched Cholesky E-step, one fused
  einsum M-step) — no per-component Python loops;
* regression is the standard GMR conditional: responsibilities from the
  X-marginal, per-component conditional means μ_y + Σ_yx Σ_xx⁻¹ (x − μ_x),
  moment-matched predictive covariance.

``predict(..., return_std=True)`` reports the moment-matched mixture std,
``samples`` draws from the exact conditional mixture, and ``derivative``
returns the analytic Jacobian of the conditional mean (responsibility
product rule), enabling J_Φ-based velocity transport — an upgrade over the
reference demo, which transports positions only.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class GMMParams(NamedTuple):
    log_weights: Array  # (K,)
    means: Array        # (K, D)
    covs: Array         # (K, D, D)


def _chol_logpdf(z: Array, mean: Array, chol: Array) -> Array:
    """log N(z; mean, L Lᵀ) for batched z: z (N, D), mean (D,), chol (D, D)."""
    d = z.shape[-1]
    diff = z - mean[None, :]
    sol = jax.scipy.linalg.solve_triangular(chol, diff.T, lower=True)  # (D, N)
    maha = jnp.sum(sol**2, axis=0)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return -0.5 * (maha + logdet + d * jnp.log(2.0 * jnp.pi))


def _e_step(z: Array, params: GMMParams):
    chols = jnp.linalg.cholesky(params.covs)
    log_comp = jax.vmap(lambda m, L: _chol_logpdf(z, m, L))(params.means, chols)
    log_joint = params.log_weights[:, None] + log_comp  # (K, N)
    log_norm = jax.scipy.special.logsumexp(log_joint, axis=0)
    return jnp.exp(log_joint - log_norm[None, :]), log_norm  # resp (K, N)


def _m_step(z: Array, resp: Array, reg: float) -> GMMParams:
    n = z.shape[0]
    nk = jnp.sum(resp, axis=1) + 1e-12  # (K,)
    means = (resp @ z) / nk[:, None]  # (K, D)
    diff = z[None, :, :] - means[:, None, :]  # (K, N, D)
    covs = jnp.einsum("kn,knd,kne->kde", resp, diff, diff) / nk[:, None, None]
    covs = covs + reg * jnp.eye(z.shape[1], dtype=z.dtype)[None]
    return GMMParams(jnp.log(nk / n), means, covs)


@partial(jax.jit, static_argnames=("n_components", "n_iter"))
def fit_gmm(
    z: Array,
    key: Array,
    n_components: int,
    n_iter: int = 100,
    reg: float = 1e-6,
):
    """EM fit of a K-component full-covariance GMM on z (N, D).

    Initialization: random data points as means (sklearn's ``init_params=
    'random_from_data'``), the data covariance (+reg) as every component's
    covariance, uniform weights.  ``reg`` is *relative* to the mean data
    variance so that curve-like (rank-deficient) point sets at any
    coordinate scale keep every component covariance SPD.  Returns
    (params, per-iteration mean log-likelihood trace)."""
    n, d = z.shape
    idx = jax.random.choice(key, n, shape=(n_components,), replace=False)
    data_cov = jnp.cov(z.T).reshape(d, d)
    reg = reg * jnp.maximum(jnp.trace(data_cov) / d, 1e-30)
    data_cov = data_cov + reg * jnp.eye(d, dtype=z.dtype)
    params0 = GMMParams(
        jnp.full((n_components,), -jnp.log(float(n_components)), z.dtype),
        z[idx],
        jnp.broadcast_to(data_cov, (n_components, d, d)).astype(z.dtype),
    )

    def step(params, _):
        resp, log_norm = _e_step(z, params)
        return _m_step(z, resp, reg), jnp.mean(log_norm)

    params, ll_trace = jax.lax.scan(step, params0, None, length=n_iter)
    return params, ll_trace


class ConditionalParams(NamedTuple):
    """Precomputed X-marginal + conditional factors of a joint GMM."""
    log_weights: Array   # (K,)
    mean_x: Array        # (K, Dx)
    mean_y: Array        # (K, Dy)
    chol_xx: Array       # (K, Dx, Dx)
    gain: Array          # (K, Dy, Dx) = Σ_yx Σ_xx⁻¹
    cond_cov: Array      # (K, Dy, Dy) = Σ_yy − Σ_yx Σ_xx⁻¹ Σ_xy


def condition_on_x(params: GMMParams, dx: int) -> ConditionalParams:
    mean_x = params.means[:, :dx]
    mean_y = params.means[:, dx:]
    sxx = params.covs[:, :dx, :dx]
    sxy = params.covs[:, :dx, dx:]
    syy = params.covs[:, dx:, dx:]
    chol_xx = jnp.linalg.cholesky(sxx)
    # gainᵀ = Σ_xx⁻¹ Σ_xy via two triangular solves
    sol = jax.vmap(jax.scipy.linalg.cho_solve, in_axes=((0, None), 0))(
        (chol_xx, True), sxy
    )  # (K, Dx, Dy)
    gain = jnp.swapaxes(sol, 1, 2)  # (K, Dy, Dx)
    cond_cov = syy - gain @ sxy
    return ConditionalParams(params.log_weights, mean_x, mean_y, chol_xx, gain, cond_cov)


def _responsibilities(cp: ConditionalParams, x: Array) -> Array:
    log_comp = jax.vmap(lambda m, L: _chol_logpdf(x, m, L))(cp.mean_x, cp.chol_xx)
    logr = cp.log_weights[:, None] + log_comp
    return jnp.exp(logr - jax.scipy.special.logsumexp(logr, axis=0)[None, :])  # (K, N)


@jax.jit
def gmr_predict(cp: ConditionalParams, x: Array):
    """Conditional mixture mean and moment-matched covariance diag at x (N, Dx).

    Returns (mean (N, Dy), var (N, Dy))."""
    r = _responsibilities(cp, x)  # (K, N)
    diff = x[None, :, :] - cp.mean_x[:, None, :]  # (K, N, Dx)
    m_k = cp.mean_y[:, None, :] + jnp.einsum("kyx,knx->kny", cp.gain, diff)  # (K, N, Dy)
    mean = jnp.einsum("kn,kny->ny", r, m_k)
    cond_var = jnp.diagonal(cp.cond_cov, axis1=1, axis2=2)  # (K, Dy)
    second = jnp.einsum("kn,kny->ny", r, cond_var[:, None, :] + m_k**2)
    var = jnp.maximum(second - mean**2, 0.0)
    return mean, var


@jax.jit
def gmr_derivative(cp: ConditionalParams, x: Array) -> Array:
    """Analytic Jacobian (N, Dy, Dx) of the GMR conditional mean.

    d/dx [Σ_k r_k m_k] = Σ_k r_k [gain_k + m_k (g_k − ḡ)ᵀ] where
    g_k = −Σ_xx⁻¹(x − μ_x) is ∇log N_k(x) and ḡ = Σ r_k g_k."""
    r = _responsibilities(cp, x)  # (K, N)
    diff = x[None, :, :] - cp.mean_x[:, None, :]  # (K, N, Dx)
    m_k = cp.mean_y[:, None, :] + jnp.einsum("kyx,knx->kny", cp.gain, diff)
    sol = jax.vmap(lambda L, d: jax.scipy.linalg.cho_solve((L, True), d.T).T)(
        cp.chol_xx, diff
    )  # (K, N, Dx) = Σ_xx⁻¹ (x − μ_x)
    g = -sol
    g_bar = jnp.einsum("kn,knx->nx", r, g)
    lin = jnp.einsum("kn,kyx->nyx", r, cp.gain)
    resp_term = jnp.einsum("kn,kny,knx->nyx", r, m_k, g - g_bar[None])
    return lin + resp_term


class GMR:
    """Duck-typed (fit/predict/derivative/samples) Gaussian mixture regressor.

    Drop-in for the reference demo's ``GaussianMixtureRegressor``
    (``surface_generalization_with_gmm.py:62``)."""

    def __init__(self, n_components: int = 10, n_iter: int = 100, reg: float = 1e-6, seed: int = 0):
        self.n_components = n_components
        self.n_iter = n_iter
        self.reg = reg
        self.seed = seed

    def fit(self, X, Y):
        X = jnp.asarray(X)
        Y = jnp.asarray(Y)
        self.dx = X.shape[1]
        z = jnp.concatenate([X, Y], axis=1)
        k = min(self.n_components, z.shape[0])
        self.params, self.ll_trace = fit_gmm(
            z, jax.random.PRNGKey(self.seed), k, self.n_iter, self.reg
        )
        self.conditional = condition_on_x(self.params, self.dx)
        return self

    def predict(self, X, return_std: bool = False):
        mean, var = gmr_predict(self.conditional, jnp.asarray(X))
        if return_std:
            return mean, jnp.sqrt(var)
        return mean

    def derivative(self, X) -> Array:
        return gmr_derivative(self.conditional, jnp.asarray(X))

    def samples(self, X, n_samples: int = 10, key=None):
        """(n_samples, N, Dy) exact conditional-mixture draws."""
        key = jax.random.PRNGKey(self.seed + 1) if key is None else key
        x = jnp.asarray(X)
        cp = self.conditional
        r = _responsibilities(cp, x)  # (K, N)
        diff = x[None, :, :] - cp.mean_x[:, None, :]
        m_k = cp.mean_y[:, None, :] + jnp.einsum("kyx,knx->kny", cp.gain, diff)
        chol_c = jnp.linalg.cholesky(
            cp.cond_cov + 1e-10 * jnp.eye(cp.cond_cov.shape[-1], dtype=cp.cond_cov.dtype)
        )
        kc, kn = jax.random.split(key)
        comp = jax.random.categorical(
            kc, jnp.log(r.T + 1e-30), axis=-1, shape=(n_samples, x.shape[0])
        )  # (S, N)
        eps = jax.random.normal(kn, (n_samples, x.shape[0], cp.mean_y.shape[1]), x.dtype)
        means_sel = jnp.take_along_axis(
            jnp.swapaxes(m_k, 0, 1)[None], comp[:, :, None, None], axis=2
        )[:, :, 0, :]  # (S, N, Dy)
        chol_sel = chol_c[comp]  # (S, N, Dy, Dy)
        return means_sel + jnp.einsum("snde,sne->snd", chol_sel, eps)
