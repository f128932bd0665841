"""Exact Gaussian-process regression.

Functional core: a fitted GP is an immutable pytree (``ExactGP``) produced by
``condition``/``fit``; prediction, sampling and the derivative (Jacobian)
posterior are pure jittable functions of that state.  Everything batches with
``vmap`` (ensembles, hyperparameter restarts) and shards with ``pjit``.

Reference parity targets:
* ``policy_transportation/models/gaussian_process.py:16-126`` — sklearn
  GPR wrapper semantics: NaN-row filtering, ``C*RBF+White`` hyperopt with
  L-BFGS restarts, epistemic-only std convention (line 49), closed-form
  RBF posterior-mean Jacobian and per-entry Jacobian variance (63-101),
  gradient of the predictive variance (104-126).

The Gram build + Cholesky + triangular solves are the FLOP hot path; they
are expressed as single large matmul/chol ops (cuBLAS/cuSOLVER on a GPU).
``condition_blocked`` conditions through the panel Cholesky of
``ops.blocked_chol`` instead, for the panel-form consumers.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ..utils import pytree as struct

from ..kernels import Kernel, RBF, White, Constant, Sum, Product, Matern
from ..kernels.stationary import DEFAULT_BOUNDS
from ..ops.blocked_chol import BlockedCholesky
from ..ops.linalg import (
    add_diagonal,
    cho_solve_lower,
    log_det_from_chol,
    tri_solve_lower,
)

# GP posterior algebra must not run through reduced-precision (TF32/bf16)
# matmul passes — the accumulated error is far above the parity gates.
_HI = jax.lax.Precision.HIGHEST

Array = jax.Array

_LOG_2PI = math.log(2.0 * math.pi)


@struct.dataclass
class ExactGP:
    """Posterior state of an exact GP: p(f | X, Y, kernel).

    Exactly one of ``L`` (dense lower Cholesky) or ``chol`` (panel-form
    :class:`~..ops.blocked_chol.BlockedCholesky`, the large-N path)
    is set.  The panel form keeps only the lower-triangle column panels
    plus diagonal-block inverses — the (N, N) dense factor never exists
    in device memory, and every downstream solve is blocked GEMMs.
    """

    kernel: Kernel
    X: Array  # (N, D) training inputs
    Y: Array  # (N, P) training targets
    alpha: Array  # (N, P) = K^{-1} Y
    L: Optional[Array] = None  # (N, N) lower Cholesky of K(X,X)+jitter I
    chol: Optional[BlockedCholesky] = None  # panel factor (large-N path)
    # Optional cached K^{-1} (the reference's own cache, gaussian_process.py:42-43).
    # When present, predict/jacobian variances use matmuls against it
    # instead of per-query triangular solves.  Worth it when Nq >> N and N
    # is small/medium; skip for large-N fits (O(N²) memory, O(N³) extra
    # solve).
    K_inv: Optional[Array] = None
    jitter: float = struct.field(pytree_node=False, default=1e-10)


def _solve_lower_any(gp: ExactGP, B: Array) -> Array:
    """L⁻¹ B through whichever factor form the GP carries."""
    if gp.chol is not None:
        return gp.chol.solve_lower(B)
    return tri_solve_lower(gp.L, B)


def _cho_solve_any(gp: ExactGP, B: Array) -> Array:
    """K⁻¹ B = L⁻ᵀ L⁻¹ B through whichever factor form the GP carries."""
    if gp.chol is not None:
        return gp.chol.solve(B)
    return cho_solve_lower(gp.L, B)


# ---------------------------------------------------------------------------
# Conditioning & marginal likelihood
# ---------------------------------------------------------------------------

def _eff_jitter(dtype, jitter: float) -> float:
    """float32 Cholesky of dense-curve Gram matrices needs ~1e-6 diagonal
    jitter even when a White term exists; float64 keeps the request.
    ``jitter`` may be a traced scalar (e.g. a jitted caller inlined under
    an outer scan) — use jnp.maximum then."""
    if jnp.dtype(dtype) == jnp.float32:
        if isinstance(jitter, (int, float)):
            return max(jitter, 1e-6)
        return jnp.maximum(jitter, 1e-6)
    return jitter


def condition(
    kernel: Kernel,
    X: Array,
    Y: Array,
    jitter: float = 1e-10,
    cache_k_inv: bool = False,
) -> ExactGP:
    """Form the GP posterior for fixed hyperparameters (jittable).

    ``cache_k_inv=True`` additionally stores K⁻¹ so downstream variance
    queries become matmuls (see :class:`ExactGP`).  One dense Cholesky at
    every N: on the H100 it beat the panel form at N = 2500, 10240 and
    20000 (``PERF.md``)."""
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    K = add_diagonal(kernel(X), _eff_jitter(X.dtype, jitter))
    L = jnp.linalg.cholesky(K)
    alpha = cho_solve_lower(L, Y2)
    K_inv = None
    if cache_k_inv:
        eye = jnp.eye(X.shape[0], dtype=X.dtype)
        K_inv = cho_solve_lower(L, eye)
        K_inv = 0.5 * (K_inv + K_inv.T)  # enforce symmetry
    return ExactGP(kernel=kernel, X=X, Y=Y2, L=L, alpha=alpha, K_inv=K_inv, jitter=jitter)


def condition_blocked(
    kernel: Kernel,
    X: Array,
    Y: Array,
    jitter: float = 1e-10,
    cache_k_inv: bool = False,
    block: int = 512,
) -> ExactGP:
    """Large-N conditioning through the panel Cholesky.

    The returned GP carries the factor in panel form (``chol``) — the
    (N, N) dense L is never materialized, and every downstream
    variance/covariance query (``predict(return_std=True)``,
    :func:`predict_cov`, :func:`jacobian` variance,
    :func:`variance_gradient`) runs through blocked-GEMM substitution
    against the retained diagonal-block inverses.

    Requires the C·stationary(+White) kernel family (RBF/Matern); callers
    gate on :func:`stationary_family_params`.
    """
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    from ..ops.blocked_chol import gram_cholesky_solve

    fam, amp, ls = stationary_family_params(kernel)
    noise = white_noise_level(kernel) + _eff_jitter(X.dtype, jitter)
    # HIGHEST: at GP-realistic conditioning (κ ≳ 1e5, e.g. the reference's
    # N=2500 3D surfaces with small White noise) a reduced-precision factor
    # is not rescued by iterative refinement
    alpha, ch = gram_cholesky_solve(
        X, Y2, ls, amp, noise, block=block,
        precision=jax.lax.Precision.HIGHEST, family=fam,
    )
    K_inv = None
    if cache_k_inv:
        eye = jnp.eye(X.shape[0], dtype=jnp.float32)
        K_inv = ch.solve(eye)
        K_inv = 0.5 * (K_inv + K_inv.T)
    return ExactGP(
        kernel=kernel, X=X, Y=Y2, alpha=alpha, L=None, chol=ch,
        K_inv=K_inv, jitter=jitter,
    )


def log_marginal_likelihood(
    kernel: Kernel, X: Array, Y: Array, jitter: float = 1e-10
) -> Array:
    """log p(Y | X, kernel), summed over output columns (sklearn semantics).

    For small N (≤ 64) this routes through :func:`_lml_small`, which
    carries the textbook analytic gradient ``½ tr((ααᵀ − P·K⁻¹) ∂K)`` as a
    custom VJP, so reverse-mode never differentiates through the Cholesky.
    """
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    if X.shape[0] <= 64:
        return _lml_small(kernel, X, Y2, jitter)
    n = X.shape[0]
    K = add_diagonal(kernel(X), jitter)
    L = jnp.linalg.cholesky(K)
    alpha = cho_solve_lower(L, Y2)
    quad = jnp.sum(Y2 * alpha)
    p = Y2.shape[1]
    return -0.5 * quad - p * (0.5 * log_det_from_chol(L) + 0.5 * n * _LOG_2PI)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _lml_small(kernel: Kernel, X: Array, Y2: Array, jitter: float) -> Array:
    return _lml_small_fwd(kernel, X, Y2, jitter)[0]


def _lml_small_fwd(kernel, X, Y2, jitter):
    n, p = X.shape[0], Y2.shape[1]
    K = add_diagonal(kernel(X), jitter)
    L = jnp.linalg.cholesky(K)
    alpha = cho_solve_lower(L, Y2)
    quad = jnp.sum(Y2 * alpha)
    val = -0.5 * quad - p * (0.5 * log_det_from_chol(L) + 0.5 * n * _LOG_2PI)
    return val, (kernel, X, Y2, L, alpha)


def _lml_small_bwd(jitter, res, g):
    kernel, X, Y2, L, alpha = res
    n, p = X.shape[0], Y2.shape[1]
    K_inv = cho_solve_lower(L, jnp.eye(n, dtype=L.dtype))
    # dLML/dK = ½(ααᵀ − P·K⁻¹); pull back through the Gram build only —
    # no AD through the factorization.
    W = 0.5 * (jnp.dot(alpha, alpha.T, precision=_HI) - p * K_inv)
    _, gram_vjp = jax.vjp(lambda k, Xv: k(Xv), kernel, X)
    gk, gX = gram_vjp(W * g)
    gY2 = -alpha * g  # dLML/dY = −K⁻¹Y
    return gk, gX, gY2


_lml_small.defvjp(_lml_small_fwd, _lml_small_bwd)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def white_noise_level(kernel: Kernel) -> Array:
    """Total additive White-noise level in a kernel expression tree."""
    if isinstance(kernel, White):
        return jnp.asarray(kernel.noise_level)
    if isinstance(kernel, Sum):
        return white_noise_level(kernel.k1) + white_noise_level(kernel.k2)
    if isinstance(kernel, Product):
        # noise inside a product is not additive noise; ignore (matches the
        # reference's k2__noise_level lookup which assumes a top-level Sum).
        return jnp.asarray(0.0)
    return jnp.asarray(0.0)


def rbf_family_params(kernel: Kernel):
    """(amplitude, lengthscale) when the kernel is the C·RBF(+White)
    transport family (the reference's default,
    ``gaussian_process_transportation.py:12``); None otherwise.

    White contributes nothing to cross-covariances, so it is ignored for
    the k(X*, X) fast path."""
    if isinstance(kernel, Sum):
        if isinstance(kernel.k2, White):
            return rbf_family_params(kernel.k1)
        if isinstance(kernel.k1, White):
            return rbf_family_params(kernel.k2)
        return None
    if isinstance(kernel, Product):
        if isinstance(kernel.k1, Constant) and isinstance(kernel.k2, RBF):
            return kernel.k1.constant_value, jnp.atleast_1d(kernel.k2.lengthscale)
        if isinstance(kernel.k2, Constant) and isinstance(kernel.k1, RBF):
            return kernel.k2.constant_value, jnp.atleast_1d(kernel.k1.lengthscale)
        return None
    if isinstance(kernel, RBF):
        return jnp.asarray(1.0), jnp.atleast_1d(kernel.lengthscale)
    return None


_MATERN_FAMILY = {0.5: "matern12", 1.5: "matern32", 2.5: "matern52", math.inf: "rbf"}


def _base_stationary_family(kernel: Kernel) -> Optional[str]:
    if isinstance(kernel, RBF):
        return "rbf"
    if isinstance(kernel, Matern):
        return _MATERN_FAMILY.get(kernel.nu)
    return None


def stationary_family_params(kernel: Kernel):
    """(family, amplitude, lengthscale) when the kernel is the
    C·stationary(+White) transport family — RBF or Matern(ν∈{½,3/2,5/2}) —
    None otherwise.  The reference's canonical policy-DS kernel is
    ``C(0.1)*Matern(ν=2.5)+White`` (``example/2D/surface_generalization.py:49``),
    so the large-N paths accept the whole family.

    White contributes nothing to cross-covariances, so it is ignored for
    the k(X*, X) fast path."""
    if isinstance(kernel, Sum):
        if isinstance(kernel.k2, White):
            return stationary_family_params(kernel.k1)
        if isinstance(kernel.k1, White):
            return stationary_family_params(kernel.k2)
        return None
    if isinstance(kernel, Product):
        if isinstance(kernel.k1, Constant):
            const, base = kernel.k1, kernel.k2
        elif isinstance(kernel.k2, Constant):
            const, base = kernel.k2, kernel.k1
        else:
            return None
        fam = _base_stationary_family(base)
        if fam is None:
            return None
        return fam, const.constant_value, jnp.atleast_1d(base.lengthscale)
    fam = _base_stationary_family(kernel)
    if fam is None:
        return None
    return fam, jnp.asarray(1.0), jnp.atleast_1d(kernel.lengthscale)


def small_lml_theta_layout(kernel: Kernel):
    """(family, n_ls, has_noise, perm) when ``kernel.theta`` maps onto the
    canonical fused-LML layout ``[log amp, log ℓ…, log noise]``
    (``ops.fused_lml``); None otherwise.

    ``perm[i]`` is the ``kernel.theta`` index of canonical row ``i`` —
    leaves flatten in declaration order (Sum/Product: k1 then k2), so the
    walk below mirrors ``Kernel.theta``'s ``tree_leaves`` ordering.
    """
    info = stationary_family_params(kernel)
    if info is None:
        return None
    family = info[0]
    pos = {}

    def walk(k, off):
        if isinstance(k, (Sum, Product)):
            off = walk(k.k1, off)
            return walk(k.k2, off)
        if isinstance(k, Constant):
            if "amp" in pos:
                raise ValueError("duplicate amplitude")
            pos["amp"] = (off, 1)
            return off + 1
        if isinstance(k, White):
            if "noise" in pos:
                raise ValueError("duplicate noise")
            pos["noise"] = (off, 1)
            return off + 1
        if _base_stationary_family(k) is not None:
            if "ls" in pos:
                raise ValueError("duplicate lengthscale")
            n_ls = int(np.size(k.lengthscale))
            pos["ls"] = (off, n_ls)
            return off + n_ls
        raise ValueError(f"unsupported kernel node {type(k).__name__}")

    try:
        total = walk(kernel, 0)
    except ValueError:
        return None
    if "amp" not in pos or "ls" not in pos:
        return None
    n_ls = pos["ls"][1]
    has_noise = "noise" in pos
    perm = [pos["amp"][0]]
    perm += list(range(pos["ls"][0], pos["ls"][0] + n_ls))
    if has_noise:
        perm.append(pos["noise"][0])
    if len(perm) != total:
        return None
    return family, n_ls, has_noise, np.asarray(perm)


def predict(
    gp: ExactGP,
    x: Array,
    return_std: bool = False,
    epistemic_only: bool = False,
) -> Array | Tuple[Array, Array]:
    """Posterior mean (and std) at query points x: (Nq, D) -> (Nq, P).

    ``return_std`` includes the White-noise level (sklearn convention);
    ``epistemic_only`` additionally subtracts sqrt(noise_level) from the std,
    reproducing the reference's convention
    (``models/gaussian_process.py:49``).

    """
    k_star = gp.kernel(x, gp.X)  # cross-cov: White contributes zeros
    mean = jnp.dot(k_star, gp.alpha, precision=_HI)
    if not return_std:
        return mean
    if gp.K_inv is not None:
        KiK = jnp.dot(k_star, gp.K_inv, precision=_HI)  # (Nq, N)
        var = gp.kernel.diag(x) - jnp.sum(KiK * k_star, axis=1)
    else:
        V = _solve_lower_any(gp, k_star.T)  # (N, Nq)
        var = gp.kernel.diag(x) - jnp.sum(V * V, axis=0)
    var = jnp.maximum(var, 0.0)
    std = jnp.sqrt(var)
    if epistemic_only:
        std = std - jnp.sqrt(white_noise_level(gp.kernel))
    std = jnp.broadcast_to(std[:, None], mean.shape)
    return mean, std


def predict_cov(gp: ExactGP, x: Array) -> Tuple[Array, Array]:
    """Posterior mean and full covariance (shared across outputs)."""
    k_star = gp.kernel(x, gp.X)
    mean = jnp.dot(k_star, gp.alpha, precision=_HI)
    V = _solve_lower_any(gp, k_star.T)
    cov = gp.kernel(x) - jnp.dot(V.T, V, precision=_HI)
    return mean, cov


def sample_y(gp: ExactGP, x: Array, key: Array, n_samples: int = 10) -> Array:
    """Draw posterior function samples; returns (n_samples, Nq, P).

    Matches the reference's ``samples`` (``gaussian_process.py:57-60``)
    which transposes sklearn's ``sample_y`` to samples-first layout.
    """
    mean, cov = predict_cov(gp, x)
    L = jnp.linalg.cholesky(add_diagonal(cov, 1e-8))
    eps = jax.random.normal(key, (n_samples, x.shape[0], mean.shape[1]), mean.dtype)
    return mean[None] + jnp.einsum("ij,sjp->sip", L, eps, precision=_HI)


# ---------------------------------------------------------------------------
# Derivative (Jacobian) posterior
# ---------------------------------------------------------------------------

def jacobian(
    gp: ExactGP, x: Array, return_var: bool = False
) -> Array | Tuple[Array, Array]:
    """Posterior mean (and per-entry variance) of ∂f/∂x at query points.

    Returns mean with shape (Nq, P, D): entry [i, p, d] = ∂f_p/∂x_d at x_i.
    The variance has the same shape and is identical across outputs p
    (shared kernel), matching ``gaussian_process.py:63-101``:
    ``var_d = k_dd''(x,x) − dk K⁻¹ dkᵀ`` with ``k_dd'' = prior_var/ℓ_d²``
    for C*RBF.
    """
    dk = gp.kernel.dx(x, gp.X)  # (Nq, N, D) = ∂k(x_i, X_n)/∂x_i
    mean = jnp.einsum("qnd,np->qpd", dk, gp.alpha, precision=_HI)
    if not return_var:
        return mean
    prior = gp.kernel.dxdz_diag(x)  # (Nq, D)
    if gp.K_inv is not None:
        dkKi = jnp.einsum("qnd,nm->qmd", dk, gp.K_inv, precision=_HI)
        quad = jnp.einsum("qmd,qmd->qd", dkKi, dk, precision=_HI)  # (Nq, D)
        var = prior - quad
    elif gp.chol is not None:
        # one blocked forward substitution over all D directions at once:
        # (N, Nq·D) RHS keeps the GEMMs large instead of D separate solves
        Nq, N, D = dk.shape
        rhs = jnp.transpose(dk, (1, 0, 2)).reshape(N, Nq * D)
        V = gp.chol.solve_lower(rhs)  # (N, Nq·D)
        quad = jnp.sum((V * V).reshape(N, Nq, D), axis=0)  # (Nq, D)
        var = prior - quad
    else:
        dkT = jnp.transpose(dk, (2, 1, 0))  # (D, N, Nq)
        V = jax.vmap(lambda B: tri_solve_lower(gp.L, B))(dkT)  # (D, N, Nq)
        quad = jnp.sum(V * V, axis=1)  # (D, Nq): diag(dk_d K⁻¹ dk_dᵀ)
        var = prior - quad.T  # (Nq, D)
    var = jnp.broadcast_to(var[:, None, :], mean.shape)
    return mean, var


def variance_gradient(gp: ExactGP, x: Array) -> Array:
    """∂σ²(x)/∂x of the predictive variance; shape (Nq, D).

    Parity with ``gaussian_process.py:104-126``:
    dσ²/dx_d = −2 · Σ_nm ∂k(x,X_n)/∂x_d [K⁻¹]_nm k(X_m, x).
    """
    k_star = gp.kernel(x, gp.X)  # (Nq, N)
    dk = gp.kernel.dx(x, gp.X)  # (Nq, N, D)
    if gp.K_inv is not None:
        Kinv_k = jnp.dot(gp.K_inv, k_star.T, precision=_HI)  # (N, Nq)
    else:
        Kinv_k = _cho_solve_any(gp, k_star.T)  # (N, Nq)
    return -2.0 * jnp.einsum("qnd,nq->qd", dk, Kinv_k, precision=_HI)


# ---------------------------------------------------------------------------
# Hyperparameter fitting
# ---------------------------------------------------------------------------

def _filter_nan_rows(X: np.ndarray, Y: np.ndarray):
    """Drop rows whose targets contain NaN (``gaussian_process.py:33-35``)."""
    mask = np.isnan(np.asarray(Y)).any(axis=1)
    if mask.any():
        return np.asarray(X)[~mask], np.asarray(Y)[~mask]
    return np.asarray(X), np.asarray(Y)


def fit(
    kernel: Kernel,
    X: Array,
    Y: Array,
    n_restarts: int = 5,
    key: Optional[Array] = None,
    jitter: float = 1e-10,
    maxiter: int = 200,
) -> ExactGP:
    """sklearn-parity hyperparameter fit: L-BFGS-B (scipy driver over a
    jitted JAX value-and-grad) with ``n_restarts`` uniform log-space
    restarts, then conditioning at the best hyperparameters.

    Host-side by design (scipy line search); use :func:`fit_jit` for the
    fully-compiled multi-restart path.
    """
    from scipy.optimize import minimize

    Xn, Yn = _filter_nan_rows(np.asarray(X), np.asarray(Y))
    if Yn.ndim == 1:
        Yn = Yn[:, None]
    Xd = jnp.asarray(Xn)
    Yd = jnp.asarray(Yn)

    bounds = np.asarray(kernel.theta_bounds)

    @jax.jit
    def value_and_grad(theta):
        k = kernel.with_theta(theta)
        return jax.value_and_grad(
            lambda t: -log_marginal_likelihood(kernel.with_theta(t), Xd, Yd, jitter)
        )(theta)

    def obj(theta_np):
        v, g = value_and_grad(jnp.asarray(theta_np))
        v = float(v)
        g = np.asarray(g, dtype=np.float64)
        if not np.isfinite(v) or not np.all(np.isfinite(g)):
            return 1e25, np.zeros_like(g)
        return v, g

    theta0 = np.asarray(kernel.theta, dtype=np.float64)
    if theta0.size == 0:
        return condition(kernel, Xd, Yd, jitter)

    if key is None:
        key = jax.random.PRNGKey(0)
    starts = [theta0]
    if n_restarts > 0:
        u = jax.random.uniform(key, (n_restarts, theta0.size))
        rand = bounds[:, 0] + np.asarray(u) * (bounds[:, 1] - bounds[:, 0])
        starts.extend(list(rand))

    best_val, best_theta = np.inf, theta0
    for s in starts:
        res = minimize(
            obj,
            s,
            jac=True,
            method="L-BFGS-B",
            bounds=list(map(tuple, bounds)),
            options={"maxiter": maxiter},
        )
        if res.fun < best_val:
            best_val, best_theta = res.fun, res.x
    fitted = kernel.with_theta(jnp.asarray(best_theta))
    return condition(fitted, Xd, Yd, jitter)


def _family_nodes(kernel: Kernel):
    """(constant_node, base_node, white_node) of a C·stationary(+White)
    kernel tree; missing wrappers come back as None."""
    const = base = white = None

    def walk(k):
        nonlocal const, base, white
        if isinstance(k, Sum):
            walk(k.k1)
            walk(k.k2)
        elif isinstance(k, Product):
            walk(k.k1)
            walk(k.k2)
        elif isinstance(k, Constant):
            const = k
        elif isinstance(k, White):
            white = k
        elif isinstance(k, (RBF, Matern)):
            base = k

    walk(kernel)
    return const, base, white


def fit_blocked(
    kernel: Kernel,
    X: Array,
    Y: Array,
    maxiter: int = 40,
    jitter: float = 1e-10,
    block: int = 512,
    precision=_HI,
    refine_iters: int = 1,
) -> ExactGP:
    """Large-N hyperparameter fit through the blocked panel Cholesky.

    The whole optimization is one compiled ``lax.scan`` of optax L-BFGS
    steps whose value-and-grad is the closed-form panel LML of
    ``ops/blocked_lml.py`` — per iteration ≈ 3·(N³/3) GEMM FLOPs
    *independent of the number of hyperparameters*, with no AD through the
    factorization and no dense (N, N) buffer.  This removes the practical
    reason for the reference's 20 000-point active-learning cap
    (``models/gaussian_process_al.py:16``): sklearn's fit there is minutes
    per restart on CPU at N=10k.

    Requires the C·stationary(+White) family (:func:`stationary_family_params`);
    the returned GP's kernel is the canonical
    ``Constant·base + White`` reconstruction at the fitted values (bounds
    preserved from the input tree).  Semantics match :func:`fit`:
    log-space L-BFGS clipped to the kernel's theta bounds, then
    conditioning at the optimum (via :func:`condition_blocked`).
    """
    from ..ops.blocked_lml import make_blocked_lml

    parts = stationary_family_params(kernel)
    if parts is None:
        raise ValueError(
            "fit_blocked requires a C*stationary(+White) kernel "
            "(RBF or Matern nu in {0.5, 1.5, 2.5}); got "
            f"{type(kernel).__name__}. Use fit/fit_jit for other kernels."
        )
    fam, amp0, ls0 = parts
    const_node, base_node, white_node = _family_nodes(kernel)

    Y2 = Y if Y.ndim == 2 else Y[:, None]
    if not isinstance(jnp.asarray(X), jax.core.Tracer):
        X, Y2 = _filter_nan_rows(X, Y2)
    X = jnp.asarray(X, jnp.float32)
    Y2 = jnp.asarray(Y2, jnp.float32)
    D = X.shape[1]

    noise0 = white_noise_level(kernel)
    theta0 = {
        "log_amp": jnp.log(jnp.asarray(amp0, jnp.float32)),
        "log_ls": jnp.log(jnp.broadcast_to(
            jnp.atleast_1d(ls0).astype(jnp.float32), (D,)
        )),
        "log_noise": jnp.log(jnp.maximum(jnp.asarray(noise0, jnp.float32), 1e-8)),
    }

    def _log_bounds(node, default=(1e-5, 1e5)):
        b = node.bounds if node is not None else default
        return math.log(b[0]), math.log(b[1])

    lo_hi = {
        "log_amp": _log_bounds(const_node),
        "log_ls": _log_bounds(base_node),
        "log_noise": _log_bounds(white_node),
    }
    lo = {k: jnp.full_like(theta0[k], v[0]) for k, v in lo_hi.items()}
    hi = {k: jnp.full_like(theta0[k], v[1]) for k, v in lo_hi.items()}

    lml = make_blocked_lml(
        fam,
        jitter=_eff_jitter(jnp.float32, jitter),
        block=block,
        precision=precision,
        refine_iters=refine_iters,
    )

    def nll(theta):
        v = -lml(theta, X, Y2)
        return jnp.where(jnp.isfinite(v), v, 1e25)

    opt = optax.lbfgs()

    @jax.jit
    def run(t0):
        state0 = opt.init(t0)

        def step(carry, _):
            theta, state = carry
            v, g = jax.value_and_grad(nll)(theta)
            g = jax.tree_util.tree_map(
                lambda x: jnp.where(jnp.isfinite(x), x, 0.0), g
            )
            updates, state = opt.update(
                g, state, theta, value=v, grad=g, value_fn=nll
            )
            theta = optax.apply_updates(theta, updates)
            theta = jax.tree_util.tree_map(jnp.clip, theta, lo, hi)
            return (theta, state), v

        (theta, _), vals = jax.lax.scan(step, (t0, state0), None, length=maxiter)
        return theta, vals

    theta, _ = run(theta0)

    base_kwargs = {"lengthscale": jnp.exp(theta["log_ls"])}
    if isinstance(base_node, Matern):
        base = Matern(nu=base_node.nu, bounds=base_node.bounds, **base_kwargs)
    else:
        base = RBF(
            bounds=base_node.bounds if base_node is not None else DEFAULT_BOUNDS,
            **base_kwargs,
        )
    fitted = Constant(
        jnp.exp(theta["log_amp"]),
        bounds=const_node.bounds if const_node is not None else DEFAULT_BOUNDS,
    ) * base + White(
        jnp.exp(theta["log_noise"]),
        bounds=white_node.bounds if white_node is not None else DEFAULT_BOUNDS,
    )
    return condition_blocked(fitted, X, Y2, jitter=jitter, block=block)


def _lbfgs_elast(value_and_grad_b, x0, lower, upper, maxiter, m=8,
                 armijo_c=1e-4, max_backtrack=6):
    """Per-lane projected L-BFGS (minimization) on (T, L) parameters.

    Every lane optimizes independently: the two-loop recursion's inner
    products are per-lane sums over the T parameter rows, histories are
    (m, T, L) rolled buffers with rho=0 masking empty/degenerate slots,
    and the Armijo backtracking line search halves each lane's step
    individually.  One batched value+grad call per candidate — built for
    the multi-data LML (``ops.fused_lml.small_lml_value_grad_md``), one
    batched computation for all L lanes.
    ``optax.lbfgs`` cannot be used here: its inner products span the whole
    parameter pytree, coupling the lanes.
    """
    T, L = x0.shape

    def dot(a, b):  # per-lane inner product over parameter rows
        return jnp.sum(a * b, axis=0)

    def clipx(x):
        return jnp.clip(x, lower, upper)

    v0, g0 = value_and_grad_b(x0)
    S0 = jnp.zeros((m, T, L), x0.dtype)
    Yh0 = jnp.zeros((m, T, L), x0.dtype)
    rho0 = jnp.zeros((m, L), x0.dtype)

    def body(_, carry):
        x, v, g, S, Yh, rho = carry
        # two-loop recursion, newest slot first
        q = g
        alphas = []
        for kk in range(m):
            a = rho[kk] * dot(S[kk], q)
            q = q - a[None, :] * Yh[kk]
            alphas.append(a)
        y0y0 = dot(Yh[0], Yh[0])
        gamma = jnp.where(
            rho[0] > 0.0, dot(S[0], Yh[0]) / jnp.maximum(y0y0, 1e-30), 1.0
        )
        r = gamma[None, :] * q
        for kk in reversed(range(m)):
            b = rho[kk] * dot(Yh[kk], r)
            r = r + S[kk] * (alphas[kk] - b)[None, :]
        d = -r
        desc = dot(d, g)
        d = jnp.where(desc[None, :] < 0.0, d, -g)  # fall back to steepest
        dg = jnp.minimum(dot(d, g), -1e-30)
        # per-lane backtracking Armijo
        t = jnp.ones((L,), x0.dtype)
        for _ in range(max_backtrack):
            v_try, _ = value_and_grad_b(clipx(x + t[None, :] * d))
            ok = v_try <= v + armijo_c * t * dg
            t = jnp.where(ok, t, 0.5 * t)
        x_new = clipx(x + t[None, :] * d)
        v_new, g_new = value_and_grad_b(x_new)
        # only keep steps that actually decreased (the last halving was
        # not re-checked); otherwise stay
        good = v_new <= v
        x_new = jnp.where(good[None, :], x_new, x)
        g_new2 = jnp.where(good[None, :], g_new, g)
        v_new2 = jnp.where(good, v_new, v)
        s = x_new - x
        yv = g_new2 - g
        sy = dot(s, yv)
        rho_new = jnp.where(sy > 1e-12, 1.0 / jnp.where(sy > 1e-12, sy, 1.0), 0.0)
        S = jnp.concatenate([s[None], S[:-1]], axis=0)
        Yh = jnp.concatenate([yv[None], Yh[:-1]], axis=0)
        rho = jnp.concatenate([rho_new[None], rho[:-1]], axis=0)
        return x_new, v_new2, g_new2, S, Yh, rho

    x, v, g, _, _, _ = jax.lax.fori_loop(
        0, maxiter, body, (x0, v0, g0, S0, Yh0, rho0)
    )
    return x, v


def fit_ensemble_fused(
    kernel: Kernel,
    Xe: Array,
    Ye: Array,
    n_restarts: int = 6,
    key: Optional[Array] = None,
    jitter: float = 1e-10,
    maxiter: int = 40,
) -> Tuple[Array, Array]:
    """Batched multi-restart hyperparameter fits: member e fits ITS OWN
    dataset (Xe[e], Ye[e]); all members × restarts optimize as ONE
    compiled program whose value+grad is one batched small-LML call per
    line-search candidate (``ops.fused_lml``).

    The reference performs this workload as one sklearn L-BFGS fit per
    ensemble member (``models/gaussian_process.py:17-29`` under
    ``transportation/``-level loops).

    Restart lanes are cheap (one more lane of the same batch), so the
    default is higher than ``fit_jit``'s — the small-N LML
    surface is multimodal (noise-dominated vs signal basins) and lanes
    are the cheap way to cover it (measured: member basins missed at 2
    restarts, all recovered at 6).

    Returns (thetas (E, n_theta) in ``kernel.theta`` order, lml (E,)).
    Requires the C·stationary(+White) family at n ≤ 32.
    """
    layout = small_lml_theta_layout(kernel)
    if layout is None:
        raise ValueError("fit_ensemble_fused needs the C·stationary(+White) family")
    family, n_ls, has_noise, perm = layout
    inv_perm = np.argsort(perm)
    from ..ops.fused_lml import small_lml_value_grad_md

    E, n, D = Xe.shape
    Ye3 = Ye if Ye.ndim == 3 else Ye[:, :, None]
    if key is None:
        key = jax.random.PRNGKey(0)
    bounds = kernel.theta_bounds
    lo, hi = bounds[:, 0], bounds[:, 1]
    T = lo.shape[0]
    R = n_restarts + 1
    L = E * R

    theta0 = kernel.theta
    u = jax.random.uniform(key, (E, n_restarts, T), dtype=jnp.float32)
    rand = lo + u * (hi - lo)
    starts = jnp.concatenate(
        [jnp.broadcast_to(theta0[None, None, :], (E, 1, T)), rand], axis=1
    )  # (E, R, T), member-major
    x0 = jnp.transpose(starts.reshape(L, T)[:, perm], (1, 0)).astype(jnp.float32)

    Xe_t = jnp.repeat(jnp.asarray(Xe), R, axis=0)
    Ye_t = jnp.repeat(jnp.asarray(Ye3), R, axis=0)
    def nll_b(th):
        val, grad = small_lml_value_grad_md(
            Xe_t, Ye_t, th, family=family, n_ls=n_ls, has_noise=has_noise,
            jitter=jitter,
        )
        v = -val
        bad = ~jnp.isfinite(v)
        v = jnp.where(bad, 1e25, v)
        g = jnp.where(jnp.isfinite(grad) & ~bad[None, :], -grad, 0.0)
        return v, g

    lo_c = jnp.asarray(lo)[perm][:, None].astype(jnp.float32)
    hi_c = jnp.asarray(hi)[perm][:, None].astype(jnp.float32)
    x, v = _lbfgs_elast(nll_b, x0, lo_c, hi_c, maxiter)

    v_er = v.reshape(E, R)
    best = jnp.argmin(v_er, axis=1)  # (E,)
    x_er = jnp.transpose(x, (1, 0)).reshape(E, R, T)
    th_best = jnp.take_along_axis(x_er, best[:, None, None], axis=1)[:, 0, :]
    return th_best[:, inv_perm], -jnp.take_along_axis(v_er, best[:, None], axis=1)[:, 0]


def fit_jit(
    kernel: Kernel,
    X: Array,
    Y: Array,
    n_restarts: int = 5,
    key: Optional[Array] = None,
    jitter: float = 1e-10,
    maxiter: int = 100,
) -> ExactGP:
    """Fully-compiled multi-restart fit: ``vmap`` of projected L-BFGS
    (optax) over restart candidates — every restart optimizes in parallel
    as one batched computation on the chip.
    """
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    # same NaN-row semantics as ``fit`` (reference gaussian_process.py:33-35).
    # The filter is host-side (data-dependent shape), so it applies only to
    # concrete inputs; under an outer jit/vmap the caller must pre-filter.
    if not isinstance(jnp.asarray(X), jax.core.Tracer):
        X, Y2 = _filter_nan_rows(X, Y2)
    X = jnp.asarray(X)
    Y2 = jnp.asarray(Y2)
    if key is None:
        key = jax.random.PRNGKey(0)

    bounds = kernel.theta_bounds
    theta0 = kernel.theta
    if theta0.size == 0:
        return condition(kernel, X, Y2, jitter)

    u = jax.random.uniform(key, (max(n_restarts, 0), theta0.size), dtype=theta0.dtype)
    rand = bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])
    starts = jnp.concatenate([theta0[None], rand], axis=0)

    def nll(theta):
        v = -log_marginal_likelihood(kernel.with_theta(theta), X, Y2, jitter)
        return jnp.where(jnp.isfinite(v), v, 1e25)

    opt = optax.lbfgs()

    def run_one(t0):
        state0 = opt.init(t0)

        def step(carry, _):
            theta, state = carry
            v, g = jax.value_and_grad(nll)(theta)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            updates, state = opt.update(
                g, state, theta, value=v, grad=g, value_fn=nll
            )
            theta = optax.apply_updates(theta, updates)
            theta = jnp.clip(theta, bounds[:, 0], bounds[:, 1])
            return (theta, state), v

        (theta, _), _ = jax.lax.scan(step, (t0, state0), None, length=maxiter)
        return theta, nll(theta)

    thetas, vals = jax.vmap(run_one)(starts)
    best = jnp.argmin(vals)
    fitted = kernel.with_theta(thetas[best])
    return condition(fitted, X, Y2, jitter)
