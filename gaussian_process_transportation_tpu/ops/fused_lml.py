"""Small-n GP log-marginal-likelihood value and gradient for many
parameter vectors at once, in plain XLA.

Hyperposterior HMC/NUTS (``parallel/samplers.py``) and the per-member
L-BFGS of ``models.exact_gp.fit_ensemble_fused`` are sequential loops
whose every step needs value+grad of the n≈20 LML for a few hundred to a
few thousand independent parameter vectors ("lanes").  Lanes are the
minor axis, and one step is the Gram build, the unrolled ensemble-last
Cholesky and triangular inverse of ``ops.batched_linalg``, and the
trace-identity gradient ∂LML/∂θ = ½⟨ααᵀ − P·K⁻¹, ∂K/∂θ⟩ in
θ = (log amp, log ℓ, log noise) — no AD anywhere.  Every lane runs the
same elementwise program, so its result does not depend on how many lanes
share the call: chains sharded over devices reproduce the unsharded run
bit for bit.  The C·stationary(+White) family is covered (reference
canonical kernels, ``gaussian_process_transportation.py:12``,
``example/2D/surface_generalization.py:49``); the value follows sklearn
semantics, summed over output columns.

:func:`small_lml_value_grad` shares one dataset across lanes,
:func:`small_lml_value_grad_md` gives every lane its own.  Parameters are
(T, E) ensemble-last in canonical order
``[log amp, log ℓ (n_ls rows), log noise (if has_noise)]``.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from .batched_linalg import cholesky_elast, inv_lower_elast, sum_lanes

Array = jax.Array

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _phi(s: Array, family: str) -> Array:
    """Unit-amplitude stationary kernel of the ℓ-scaled squared distance
    (same formulas as ``ops.blocked_chol.stationary_from_sqdist``)."""
    if family == "rbf":
        return jnp.exp(-0.5 * s)
    d = jnp.sqrt(s + 1e-36)
    if family == "matern12":
        return jnp.exp(-d)
    if family == "matern32":
        return (1.0 + _SQRT3 * d) * jnp.exp(-_SQRT3 * d)
    if family == "matern52":
        sd = _SQRT5 * d
        return (1.0 + sd + sd * sd / 3.0) * jnp.exp(-sd)
    raise ValueError(f"unknown stationary family {family!r}")


def _dphi(s: Array, family: str) -> Array:
    """∂φ/∂s (same as ``ops.blocked_lml.stationary_dk_dd2``)."""
    if family == "rbf":
        return -0.5 * jnp.exp(-0.5 * s)
    d = jnp.sqrt(s + 1e-36)
    if family == "matern12":
        return -jnp.exp(-d) / (2.0 * jnp.maximum(d, 1e-18))
    if family == "matern32":
        return -1.5 * jnp.exp(-_SQRT3 * d)
    if family == "matern52":
        sd = _SQRT5 * d
        return -(5.0 / 6.0) * (1.0 + sd) * jnp.exp(-sd)
    raise ValueError(f"unknown stationary family {family!r}")


def _sq_dists(Xt: Array) -> list:
    """Per-dimension squared distances [(n, n, E|1)] of Xt (n, D, E|1)."""
    Xf = Xt.astype(jnp.float32)
    out = []
    for d in range(Xf.shape[1]):
        diff = Xf[:, None, d] - Xf[None, :, d]
        out.append(diff * diff)
    return out


def _value_grad(d2: list, Y: Array, theta: Array, family: str, n_ls: int,
                has_noise: bool, jitter: float) -> Tuple[Array, Array]:
    """Per-lane core: d2 [(n, n, E|1)] per input dimension, Y (n, p, E|1),
    theta (T, E).  Every lane runs the same elementwise program, and every
    sum is a fixed-order :func:`sum_lanes`, so lane e's result is the same
    whatever E is."""
    E = theta.shape[1]
    n, p = Y.shape[0], Y.shape[1]
    th = theta.astype(jnp.float32)
    amp = jnp.exp(th[0])                                      # (E,)
    inv_ls2 = [jnp.exp(-2.0 * th[1 + (d if n_ls > 1 else 0)])
               for d in range(len(d2))]
    noise = jnp.exp(th[1 + n_ls]) if has_noise else jnp.zeros(E, jnp.float32)

    s = d2[0] * inv_ls2[0]
    for d in range(1, len(d2)):
        s = s + d2[d] * inv_ls2[d]                            # (n, n, E)
    ph = _phi(s, family)
    eye = jnp.eye(n, dtype=jnp.float32)[:, :, None]
    K = amp * ph + eye * (noise + jitter)
    L = cholesky_elast(K)
    Li = inv_lower_elast(L)
    K_inv = sum_lanes(Li[:, :, None] * Li[:, None, :])        # L⁻ᵀL⁻¹ (n, n, E)
    Yb = jnp.broadcast_to(Y.astype(jnp.float32), (n, p, E))
    alpha = sum_lanes(jnp.moveaxis(K_inv[:, :, None] * Yb[None], 1, 0))  # (n, p, E)
    diag_L = jnp.stack([L[i, i] for i in range(n)], axis=0)   # (n, E)
    logdet = 2.0 * sum_lanes(jnp.log(diag_L))
    quad = sum_lanes((Yb * alpha).reshape(n * p, E))
    val = -0.5 * quad - p * (0.5 * logdet + 0.5 * n * _LOG_2PI)

    aa = alpha[:, None, 0] * alpha[None, :, 0]
    for q in range(1, p):
        aa = aa + alpha[:, None, q] * alpha[None, :, q]
    W = 0.5 * (aa - p * K_inv)                                # (n, n, E)

    def total(x):                                             # (n, n, E) -> (E,)
        return sum_lanes(x.reshape(n * n, E))

    g_amp = total(W * amp * ph)
    Wdk = W * amp * _dphi(s, family)
    per_dim = [total(Wdk * d2[d]) * (-2.0 * inv_ls2[d]) for d in range(len(d2))]
    if n_ls == 1:
        g = per_dim[0]
        for d in range(1, len(d2)):
            g = g + per_dim[d]
        per_dim = [g]
    out = [g_amp] + per_dim
    if has_noise:
        out.append(noise * sum_lanes(jnp.stack([W[i, i] for i in range(n)])))
    return val, jnp.stack(out, axis=0)


def _check_layout(theta, n_ls, has_noise):
    T = 1 + n_ls + int(has_noise)
    if theta.shape[0] != T:
        raise ValueError(f"theta rows {theta.shape[0]} != layout T={T}")


def small_lml_value_grad(
    X: Array,
    Y: Array,
    theta: Array,
    family: str = "rbf",
    n_ls: int = 1,
    has_noise: bool = True,
    jitter: float = 1e-10,
) -> Tuple[Array, Array]:
    """(LML values (E,), gradients (T, E)) for E parameter vectors of one
    small GP: X (n, D) and Y (n, p) are shared by every lane."""
    _check_layout(theta, n_ls, has_noise)
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    return _value_grad(_sq_dists(X[:, :, None]), Y2[:, :, None], theta, family,
                       n_ls, has_noise, jitter)


def small_lml_value_grad_md(
    Xe: Array,
    Ye: Array,
    theta: Array,
    family: str = "rbf",
    n_ls: int = 1,
    has_noise: bool = True,
    jitter: float = 1e-10,
) -> Tuple[Array, Array]:
    """Multi-data LML: lane e evaluates ITS OWN dataset (Xe[e], Ye[e]) at
    theta[:, e].  Shapes: Xe (E, n, D), Ye (E, n, p), theta (T, E) →
    ((E,), (T, E)).  The batched-hyperopt building block (each
    transport-ensemble member fits its own residual dataset)."""
    _check_layout(theta, n_ls, has_noise)
    Ye3 = Ye if Ye.ndim == 3 else Ye[:, :, None]
    return _value_grad(_sq_dists(jnp.moveaxis(Xe, 0, -1)),
                       jnp.moveaxis(Ye3, 0, -1), theta, family, n_ls, has_noise,
                       jitter)
