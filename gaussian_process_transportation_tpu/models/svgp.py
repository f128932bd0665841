"""Sparse variational Gaussian processes (SVGP) in JAX.

Re-designs the reference's gpytorch stack
(``models/torch/stocastic_variational_gaussian_process.py:15-115`` and the
derivative-posterior variant ``..._derivatives.py:15-201``) as pure JAX:

* Whitened variational parameterization q(w) = N(m_w, S_w), u = L_K w —
  better conditioned than gpytorch's non-whitened Cholesky distribution but
  equivalent in function space.
* Independent multitask batching via ``vmap`` over the task axis (the
  reference uses per-task batched kernels/variational distributions —
  gpytorch ``IndependentMultitaskVariationalStrategy``).
* Minibatch ELBO training is a ``lax.scan`` over pre-permuted minibatches
  inside ONE jit — no Python-loop epoch overhead, no host↔device traffic
  per step (the reference pays a .cuda() transfer per batch,
  ``..._derivatives.py:179-181``).
* ``collapse``: converts the trained variational posterior to an exact-GP
  form on the inducing set (parity with gpytorch ``pseudo_points`` +
  ``convert_to_exact_gp``, ``..._derivatives.py:72-78``).  Derivation:
  with q(u)=N(m,S) on K=K_uu, the predictive q(f*) = N(k*ᵀK⁻¹m,
  k** − k*ᵀ K⁻¹(K−S)K⁻¹ k*), so the collapsed state stores
  α = K⁻¹m and C with CCᵀ = K⁻¹(K−S)K⁻¹ (C = K⁻¹ L_A, A=K−S=L_A L_Aᵀ).
* ``posterior_f`` / ``posterior_f_prime``: mean/std of f and of the
  Jacobian ∂f/∂x at query points (valid for stationary kernels — same
  caveat as the reference notes at ``..._derivatives.py:141``).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ..utils import pytree as struct

_HI = jax.lax.Precision.HIGHEST

from ..kernels import Kernel, RBF, White, Constant
from ..ops.linalg import add_diagonal, cho_solve_lower, tri_solve_lower

Array = jax.Array

_LOG_2PI = math.log(2.0 * math.pi)


def _eff_jitter(dtype, jitter: float) -> float:
    """float32 Cholesky needs ~1e-4 diagonal jitter when inducing points
    are near-duplicates (dense curve samples); float64 keeps the requested
    value."""
    if jnp.dtype(dtype) == jnp.float32:
        return max(jitter, 1e-4)
    return jitter


@struct.dataclass
class SVGPParams:
    """Trainable parameters, batched over the task (output) axis T."""

    theta: Array  # (T, n_theta) kernel log-hyperparams per task
    Z: Array  # (T, M, D) inducing locations
    m_w: Array  # (T, M) whitened variational mean
    L_w_raw: Array  # (T, M, M) raw lower factor (diag softplus-ed)
    raw_noise: Array  # () global likelihood noise (softplus)


@struct.dataclass
class SVGPState:
    """Trained model: params + static info."""

    params: SVGPParams
    kernel: Kernel  # structure template (its own param values are unused)
    jitter: float = struct.field(pytree_node=False, default=1e-6)

    @property
    def noise(self) -> Array:
        return jax.nn.softplus(self.params.raw_noise)


@struct.dataclass
class CollapsedSVGP:
    """Exact-GP form of the variational posterior on the inducing set.

    Predictives use the identity
      k* K⁻¹(K−S)K⁻¹ k*ᵀ = ‖a‖² − ‖L_wᵀ a‖²,  a = L_K⁻¹ k*ᵀ
    (S = L_K S_w L_Kᵀ in the whitened parameterization), which stays exact
    and NaN-free even when the optimized S_w is not ⪯ I — unlike forming
    chol(K−S) the way gpytorch's pseudo-point conversion does."""

    theta: Array  # (T, n_theta)
    Z: Array  # (T, M, D)
    alpha: Array  # (T, M)   = K⁻¹ m_u
    Lk: Array  # (T, M, M) chol of K_uu + jitter
    Lw: Array  # (T, M, M) whitened variational chol factor
    kernel: Kernel  # structure template


def _tril_with_softplus_diag(L_raw: Array) -> Array:
    L = jnp.tril(L_raw, -1)
    return L + jnp.diag(jax.nn.softplus(jnp.diagonal(L_raw)))


def init_params(
    kernel: Kernel,
    X: Array,
    Y: Array,
    num_inducing: int,
    key: Array,
    noise_init: float = 0.1,
) -> SVGPParams:
    """Inducing points sampled from the data per task (reference samples
    random data subsets, ``stocastic_variational_gaussian_process.py:18-25``);
    variational mean warm-started from the targets at those points
    (reference line 44)."""
    N, D = X.shape
    T = Y.shape[1]
    keys = jax.random.split(key, T)

    def per_task(k, y):
        idx = jax.random.choice(k, N, (num_inducing,), replace=num_inducing > N)
        return X[idx], y[idx]

    Z, y_at_Z = jax.vmap(per_task)(keys, Y.T)  # (T,M,D), (T,M)
    theta = jnp.tile(kernel.theta[None, :], (T, 1))
    M = num_inducing
    # whitened warm start: m_w = L_K⁻¹ y_at_Z ≈ scaled targets; use y directly
    m_w = y_at_Z
    eye = jnp.eye(M)
    # softplus⁻¹(1) so the initial S_w ≈ I
    L_w_raw = jnp.tile((math.log(math.e - 1.0) * eye)[None], (T, 1, 1))
    inv_softplus = math.log(math.expm1(noise_init))
    return SVGPParams(
        theta=theta,
        Z=Z,
        m_w=m_w,
        L_w_raw=L_w_raw,
        raw_noise=jnp.asarray(inv_softplus),
    )


def _task_elbo(
    kernel: Kernel,
    theta_t: Array,
    Z_t: Array,
    m_w: Array,
    L_w_raw: Array,
    noise: Array,
    x: Array,
    y_t: Array,
    n_total: int,
    jitter: float,
) -> Array:
    """Single-task minibatch ELBO (Hensman et al. 2013, whitened)."""
    k = kernel.with_theta(theta_t)
    M = Z_t.shape[0]
    B = x.shape[0]
    Kmm = add_diagonal(k(Z_t), _eff_jitter(Z_t.dtype, jitter))
    Lk = jnp.linalg.cholesky(Kmm)
    Kmx = k(Z_t, x)  # (M, B)
    A = tri_solve_lower(Lk, Kmx)  # (M, B)
    mu = jnp.dot(A.T, m_w, precision=_HI)  # (B,)
    Lw = _tril_with_softplus_diag(L_w_raw)
    SA = jnp.dot(Lw.T, A, precision=_HI)  # (M, B)
    kxx = k.diag(x)
    qvar = kxx - jnp.sum(A * A, axis=0) + jnp.sum(SA * SA, axis=0)
    qvar = jnp.maximum(qvar, 1e-12)

    expected_ll = -0.5 * (
        _LOG_2PI + jnp.log(noise) + ((y_t - mu) ** 2 + qvar) / noise
    )
    kl = 0.5 * (
        jnp.sum(Lw * Lw)
        + jnp.dot(m_w, m_w)
        - M
        - 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lw)))
    )
    return (n_total / B) * jnp.sum(expected_ll) - kl


def elbo(state_kernel: Kernel, params: SVGPParams, x: Array, y: Array, n_total: int, jitter: float) -> Array:
    """Total ELBO summed over independent tasks (y: (B, T))."""
    noise = jax.nn.softplus(params.raw_noise)
    per_task = jax.vmap(
        lambda th, z, mw, lw, yt: _task_elbo(
            state_kernel, th, z, mw, lw, noise, x, yt, n_total, jitter
        )
    )(params.theta, params.Z, params.m_w, params.L_w_raw, y.T)
    return jnp.sum(per_task)


def fit(
    kernel: Kernel,
    X: Array,
    Y: Array,
    num_inducing: int = 100,
    num_epochs: int = 100,
    batch_size: int = 128,
    learning_rate: float = 0.01,
    key: Optional[Array] = None,
    jitter: float = 1e-6,
    noise_init: float = 0.1,
) -> SVGPState:
    """Train an independent-multitask SVGP with minibatch Adam.

    The whole training run — every epoch, every minibatch — is one
    ``lax.scan`` inside one jit.  (Reference: Python loop over a
    DataLoader with batch_size=10 and per-batch host→GPU copies,
    ``stocastic_variational_gaussian_process.py:67-89``.)
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y if Y.ndim == 2 else Y[:, None])
    N = X.shape[0]
    key = jax.random.PRNGKey(0) if key is None else key
    k_init, k_perm = jax.random.split(key)
    params = init_params(kernel, X, Y, num_inducing, k_init, noise_init)

    batch_size = min(batch_size, N)
    steps_per_epoch = N // batch_size
    total_steps = num_epochs * steps_per_epoch

    # Pre-compute the full minibatch index schedule: (total_steps, B)
    def epoch_perm(k):
        return jax.random.permutation(k, N)[: steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size
        )

    sched = jax.vmap(epoch_perm)(jax.random.split(k_perm, num_epochs)).reshape(
        total_steps, batch_size
    )

    opt = optax.adam(learning_rate)

    @jax.jit
    def train(params, sched):
        opt_state = opt.init(params)

        def step(carry, idx):
            params, opt_state = carry
            xb, yb = X[idx], Y[idx]
            loss, g = jax.value_and_grad(
                lambda p: -elbo(kernel, p, xb, yb, N, jitter)
            )(params)
            # skip the update on non-finite steps (f32 chol can transiently
            # fail while hyperparameters move through bad regions)
            ok = jnp.isfinite(loss)
            g = jax.tree_util.tree_map(
                lambda a: jnp.where(ok & jnp.isfinite(a), a, 0.0), g
            )
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, _), losses = jax.lax.scan(step, (params, opt_state), sched)
        return params, losses

    params, losses = train(params, sched)
    return SVGPState(params=params, kernel=kernel, jitter=jitter)


def fit_natgrad(
    kernel: Kernel,
    X: Array,
    Y: Array,
    num_inducing: int = 100,
    num_epochs: int = 100,
    batch_size: int = 128,
    learning_rate: float = 0.01,
    nat_step: float = 0.5,
    key: Optional[Array] = None,
    jitter: float = 1e-6,
    noise_init: float = 0.1,
) -> SVGPState:
    """SVGP training with NATURAL-gradient variational updates.

    With a Gaussian likelihood the per-batch optimal natural parameters of
    q(w) = N(m, S) (whitened, prior N(0, I)) are closed-form:

        Λ* = I + (N/B)/σ² · A Aᵀ,   h* = (N/B)/σ² · A y_b,   A = L_K⁻¹ K_zx

    so the stochastic natural-gradient step is a convex combination in
    natural-parameter space, λ ← (1−ρ)λ + ρλ*, while kernel
    hyperparameters / inducing locations / noise follow Adam on the ELBO.
    Converges in far fewer passes than Adam-only on the variational
    parameters (Hensman 2013 §3; the "natural-gradient option" of
    SURVEY.md §7.4)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y if Y.ndim == 2 else Y[:, None])
    N = X.shape[0]
    T = Y.shape[1]
    key = jax.random.PRNGKey(0) if key is None else key
    k_init, k_perm = jax.random.split(key)
    params = init_params(kernel, X, Y, num_inducing, k_init, noise_init)
    M = params.Z.shape[1]

    # natural parameters per task: Λ (M, M) precision, h (M,) linear
    Lam = jnp.tile(jnp.eye(M)[None], (T, 1, 1))
    h = jnp.zeros((T, M))

    batch_size = min(batch_size, N)
    steps_per_epoch = N // batch_size
    sched = jax.vmap(
        lambda k: jax.random.permutation(k, N)[: steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size
        )
    )(jax.random.split(k_perm, num_epochs)).reshape(-1, batch_size)

    opt = optax.adam(learning_rate)
    hyper = (params.theta, params.Z, params.raw_noise)

    def nat_to_moment(Lam_t, h_t):
        S = jnp.linalg.inv(Lam_t)
        m = S @ h_t
        L = jnp.linalg.cholesky(add_diagonal(S, 1e-10))
        # encode back into the raw-softplus-diag form used by the ELBO
        diag = jnp.diagonal(L)
        raw_diag = jnp.log(jnp.expm1(jnp.maximum(diag, 1e-10)))
        L_raw = jnp.tril(L, -1) + jnp.diag(raw_diag)
        return m, L_raw

    @jax.jit
    def train(hyper, Lam, h, sched):
        opt_state = opt.init(hyper)

        def step(carry, idx):
            hyper, Lam, h, opt_state = carry
            theta, Z, raw_noise = hyper
            noise = jax.nn.softplus(raw_noise)
            xb, yb = X[idx], Y[idx]

            # ---- natural-gradient update of (Λ, h) per task -------------
            def nat_update(theta_t, Z_t, Lam_t, h_t, y_t):
                k = kernel.with_theta(theta_t)
                Kmm = add_diagonal(k(Z_t), _eff_jitter(Z_t.dtype, jitter))
                Lk = jnp.linalg.cholesky(Kmm)
                A = tri_solve_lower(Lk, k(Z_t, xb))  # (M, B)
                scale = (N / xb.shape[0]) / noise
                Lam_star = jnp.eye(M) + scale * (A @ A.T)
                h_star = scale * (A @ y_t)
                return (1 - nat_step) * Lam_t + nat_step * Lam_star, (
                    1 - nat_step
                ) * h_t + nat_step * h_star

            Lam, h = jax.vmap(nat_update)(theta, Z, Lam, h, yb.T)
            m_w, L_raw = jax.vmap(nat_to_moment)(Lam, h)

            # ---- Adam on hyperparameters against the ELBO ---------------
            def neg_elbo(hyp):
                th, Zh, rn = hyp
                p = SVGPParams(theta=th, Z=Zh, m_w=m_w, L_w_raw=L_raw, raw_noise=rn)
                return -elbo(kernel, p, xb, yb, N, jitter)

            loss, g = jax.value_and_grad(neg_elbo)(hyper)
            updates, opt_state = opt.update(g, opt_state, hyper)
            hyper = optax.apply_updates(hyper, updates)
            return (hyper, Lam, h, opt_state), loss

        (hyper, Lam, h, _), losses = jax.lax.scan(step, (hyper, Lam, h, opt_state), sched)
        return hyper, Lam, h, losses

    hyper, Lam, h, losses = train(hyper, Lam, h, sched)
    theta, Z, raw_noise = hyper
    m_w, L_raw = jax.vmap(nat_to_moment)(Lam, h)
    params = SVGPParams(theta=theta, Z=Z, m_w=m_w, L_w_raw=L_raw, raw_noise=raw_noise)
    return SVGPState(params=params, kernel=kernel, jitter=jitter)


# ---------------------------------------------------------------------------
# Collapse to exact GP + posteriors (parity with component #9)
# ---------------------------------------------------------------------------

def collapse(state: SVGPState) -> CollapsedSVGP:
    """Variational posterior → exact-GP form on the inducing set.

    q(u) = N(m_u, S_u) with m_u = L_K m_w, S_u = L_K S_w L_Kᵀ (whitened→
    function space), then α = K⁻¹ m_u = L_K⁻ᵀ m_w — all triangular solves.
    """
    p = state.params
    jitter = state.jitter

    def per_task(theta_t, Z_t, m_w, L_w_raw):
        k = state.kernel.with_theta(theta_t)
        Kmm = add_diagonal(k(Z_t), _eff_jitter(Z_t.dtype, jitter))
        Lk = jnp.linalg.cholesky(Kmm)
        alpha = jax.scipy.linalg.solve_triangular(Lk.T, m_w, lower=False)
        Lw = _tril_with_softplus_diag(L_w_raw)
        return alpha, Lk, Lw

    alpha, Lk, Lw = jax.vmap(per_task)(p.theta, p.Z, p.m_w, p.L_w_raw)
    return CollapsedSVGP(
        theta=p.theta, Z=p.Z, alpha=alpha, Lk=Lk, Lw=Lw, kernel=state.kernel
    )


def posterior_f(c: CollapsedSVGP, x: Array) -> Tuple[Array, Array]:
    """Mean and std of f at x: (Nq, T) each.

    Parity: ``..._derivatives.py:113-129`` (epistemic posterior over the
    latent f, no likelihood noise added)."""

    def per_task(theta_t, Z_t, alpha_t, Lk_t, Lw_t):
        k = c.kernel.with_theta(theta_t)
        k_star = k(x, Z_t)  # (Nq, M)
        mean = jnp.dot(k_star, alpha_t, precision=_HI)
        a = tri_solve_lower(Lk_t, k_star.T)  # (M, Nq)
        b = jnp.dot(Lw_t.T, a, precision=_HI)  # (M, Nq)
        var = k.diag(x) - jnp.sum(a * a, axis=0) + jnp.sum(b * b, axis=0)
        return mean, jnp.sqrt(jnp.maximum(var, 0.0))

    mean, std = jax.vmap(per_task)(c.theta, c.Z, c.alpha, c.Lk, c.Lw)
    return mean.T, std.T


def posterior_f_prime(c: CollapsedSVGP, x: Array) -> Tuple[Array, Array]:
    """Mean and std of ∂f/∂x at x: (Nq, T, D) each.

    J mean = ∂k(x,Z)/∂x α; per-entry std via the derivative-kernel
    variance  k''_dd(x,x) − dk_d [K⁻¹(K−S)K⁻¹] dk_dᵀ
    (parity: ``..._derivatives.py:132-153``, which uses autograd
    Jacobian/Hessian of the kernel — ours is closed-form)."""

    def per_task(theta_t, Z_t, alpha_t, Lk_t, Lw_t):
        k = c.kernel.with_theta(theta_t)
        dk = k.dx(x, Z_t)  # (Nq, M, D)
        mean = jnp.einsum("qmd,m->qd", dk, alpha_t, precision=_HI)
        # a_d = L_K⁻¹ dk_dᵀ per derivative direction d
        dkT = jnp.transpose(dk, (2, 1, 0))  # (D, M, Nq)
        a = jax.vmap(lambda B: tri_solve_lower(Lk_t, B))(dkT)  # (D, M, Nq)
        b = jnp.einsum("mr,dmq->drq", Lw_t, a, precision=_HI)  # (D, M, Nq)
        quad = jnp.sum(a * a, axis=1) - jnp.sum(b * b, axis=1)  # (D, Nq)
        prior = k.dxdz_diag(x)  # (Nq, D)
        var = jnp.maximum(prior - quad.T, 0.0)
        return mean, jnp.sqrt(var)

    mean, std = jax.vmap(per_task)(c.theta, c.Z, c.alpha, c.Lk, c.Lw)
    return jnp.transpose(mean, (1, 0, 2)), jnp.transpose(std, (1, 0, 2))


def sample_f(c: CollapsedSVGP, x: Array, key: Array, n_samples: int = 10) -> Array:
    """Posterior function samples: (n_samples, Nq, T)."""

    def per_task(theta_t, Z_t, alpha_t, Lk_t, Lw_t, k_t):
        k = c.kernel.with_theta(theta_t)
        k_star = k(x, Z_t)
        mean = jnp.dot(k_star, alpha_t, precision=_HI)
        a = tri_solve_lower(Lk_t, k_star.T)  # (M, Nq)
        b = jnp.dot(Lw_t.T, a, precision=_HI)
        cov = k(x) - jnp.dot(a.T, a, precision=_HI) + jnp.dot(b.T, b, precision=_HI)
        L = jnp.linalg.cholesky(add_diagonal(cov, 1e-8))
        eps = jax.random.normal(k_t, (n_samples, x.shape[0]))
        return mean[None] + eps @ L.T

    keys = jax.random.split(key, c.theta.shape[0])
    s = jax.vmap(per_task)(c.theta, c.Z, c.alpha, c.Lk, c.Lw, keys)  # (T, S, Nq)
    return jnp.transpose(s, (1, 2, 0))


# ---------------------------------------------------------------------------
# Duck-typed wrapper (reference interface)
# ---------------------------------------------------------------------------

class StochasticVariationalGaussianProcess:
    """Reference-interface wrapper
    (``models/torch/stocastic_variational_gaussian_process_derivatives.py:155-201``):
    construct with (X, Y, num_inducing), call ``fit(num_epochs)``, then
    ``predict`` / ``derivative`` / ``samples`` use the collapsed exact form.
    """

    def __init__(self, X, Y, num_inducing: int = 100, kernel: Optional[Kernel] = None, seed: int = 0):
        self.X = jnp.asarray(X)
        Y = np.asarray(Y)
        self.Y = jnp.asarray(Y if Y.ndim == 2 else Y[:, None])
        self.num_inducing = min(num_inducing, self.X.shape[0])
        D = self.X.shape[1]
        self.kernel = kernel if kernel is not None else Constant(1.0) * RBF(jnp.ones(D))
        self.seed = seed
        self.state: Optional[SVGPState] = None
        self.collapsed: Optional[CollapsedSVGP] = None

    def fit(self, num_epochs: int = 100, batch_size: int = 128, learning_rate: float = 0.01):
        self.state = fit(
            self.kernel,
            self.X,
            self.Y,
            num_inducing=self.num_inducing,
            num_epochs=num_epochs,
            batch_size=batch_size,
            learning_rate=learning_rate,
            key=jax.random.PRNGKey(self.seed),
        )
        self.collapsed = collapse(self.state)
        return self

    def predict(self, x, return_std: bool = False):
        mean, std = posterior_f(self.collapsed, jnp.asarray(x))
        if return_std:
            return mean, std
        return mean

    def derivative(self, x, return_var: bool = False):
        mean, std = posterior_f_prime(self.collapsed, jnp.asarray(x))
        mean = jnp.transpose(mean, (0, 1, 2))
        if return_var:
            return mean, std**2
        return mean

    def samples(self, x, n_samples: int = 10, key=None):
        key = jax.random.PRNGKey(self.seed + 1) if key is None else key
        return sample_f(self.collapsed, jnp.asarray(x), key, n_samples)
