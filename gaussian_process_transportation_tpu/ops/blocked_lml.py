"""Exact large-N log-marginal likelihood with closed-form gradients through
the blocked panel Cholesky — GP hyperparameter optimization at the
reference's active-learning scale (N up to 20 000+).

Why this exists: the reference fits GP hyperparameters with sklearn's
L-BFGS (``policy_transportation/models/gaussian_process.py:17-29``), whose
per-iteration cost is a dense CPU Cholesky *plus* one O(N³) trace per
hyperparameter — minutes at N=10k, and its active-learning model caps the
training set at 20 000 points (``models/gaussian_process_al.py:16``)
largely because of it.  Our small/medium-N path (``models/exact_gp.py``)
routes reverse-mode AD around the factorization with a custom VJP, but it
still materializes the dense (N, N) factor and K⁻¹.

Here the whole gradient pipeline stays in the lower-triangle *column-panel*
representation of ``ops/blocked_chol.py`` (the full (N, N) never exists in
device memory) and is GEMM-shaped:

* :func:`tri_inverse_panels` — L⁻¹ in panel form: per column-panel, a
  shrinking blocked forward substitution seeded with the retained
  diagonal-block inverses (2 GEMMs per panel step; exact N³/3 FLOPs).
* :func:`kinv_panels` — K⁻¹ = L⁻ᵀL⁻¹ in panel form: one tall GEMM per
  block pair (N³/3 FLOPs).
* :func:`blocked_lml_value_and_grad` — the textbook trace identity
  ``∂LML/∂θ = ½⟨ααᵀ − P·K⁻¹, ∂K/∂θ⟩`` evaluated panel-by-panel: ∂K/∂θ is
  rebuilt elementwise per panel (one fused pass per hyperparameter),
  so the gradient cost is 2·N³/3 GEMM FLOPs **independent of the number
  of hyperparameters** — vs sklearn's O(N³) *per* hyperparameter
  (sklearn ``gaussian_process/_gpr.py`` computes
  ``K_inv = cho_solve(...)`` then one einsum per θ; the reference invokes
  it through ``optimizer='fmin_l_bfgs_b'``).

Gradients cover the C·stationary(+White) transport family — θ =
(log amplitude, log ARD lengthscales, log noise) for
family ∈ {rbf, matern12, matern32, matern52} — the reference's canonical
policy-DS kernels (``example/2D/surface_generalization.py:49``,
``gaussian_process_transportation.py:12``).

:func:`make_blocked_lml` wraps it all as a ``jax.custom_vjp`` scalar so
``jax.value_and_grad`` / optax L-BFGS work with zero AD through the
factorization; ``models/exact_gp.fit_blocked`` is the user-facing fit.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .blocked_chol import (
    BlockedCholesky,
    cholesky_panels,
    stationary_from_sqdist,
    stationary_gram_panels,
    symmetric_matvec_panels,
)

Array = jax.Array

_HIGHEST = jax.lax.Precision.HIGHEST
_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _dot(a: Array, b: Array, precision) -> Array:
    return jnp.dot(a, b, preferred_element_type=jnp.float32, precision=precision)


def stationary_dk_dd2(d2: Array, family: str) -> Array:
    """∂k/∂(d²) for the unit-amplitude stationary family on ℓ-scaled inputs.

    Chain rule partner of :func:`stationary_from_sqdist`:
    ∂K/∂log ℓ_d = amp · k'(d²) · (−2 Δ_d²/ℓ_d²).
    matern12 is not differentiable at d = 0; the 1/d factor is guarded and
    its numerator Δ_d² vanishes faster, so the product is well-defined (0).
    """
    if family == "rbf":
        return -0.5 * jnp.exp(-0.5 * d2)
    d = jnp.sqrt(d2 + 1e-36)
    if family == "matern12":
        return -jnp.exp(-d) / (2.0 * jnp.maximum(d, 1e-18))
    if family == "matern32":
        # k = (1+√3d)e^{−√3d};  dk/dd = −3d e^{−√3d};  dk/dd² = −(3/2)e^{−√3d}
        return -1.5 * jnp.exp(-_SQRT3 * d)
    if family == "matern52":
        # k = (1+√5d+5d²/3)e^{−√5d};  dk/dd² = −(5/6)(1+√5d)e^{−√5d}
        s = _SQRT5 * d
        return -(5.0 / 6.0) * (1.0 + s) * jnp.exp(-s)
    raise ValueError(f"unknown stationary family {family!r}")


# ---------------------------------------------------------------------------
# Panel-form triangular inverse and K^{-1}
# ---------------------------------------------------------------------------


def _dense_lower(panels: Sequence[Array], B: int, Np: int) -> Array:
    """Dense lower-triangular buffer from column panels — O(P) writes, each
    slice written exactly once so XLA keeps it in place."""
    Ld = jnp.zeros((Np, Np), jnp.float32)
    for k, p in enumerate(panels):
        Ld = jax.lax.dynamic_update_slice(
            Ld, p.astype(jnp.float32), (k * B, k * B)
        )
    return Ld


def tri_inverse_panels(
    chol: BlockedCholesky, precision=_HIGHEST, chunks: int = 6
) -> list:
    """L⁻¹ as lower-triangle column panels (same layout as ``chol.panels``).

    Row-block recurrence with O(P) GEMMs: block row i of T = L⁻¹ is
    ``T[i, :iB] = −L_ii⁻¹ · (L[i, :iB] @ T[:iB, :iB])`` — ONE history GEMM
    against the dense T accumulated so far, chunked ``chunks``-ways over
    the output columns so each chunk's GEMM starts at the first nonzero
    row of T (the strictly-upper zeros are skipped exactly; FLOPs ≈
    (C+1)/2C · N³/3 vs the substitution form's N³/6, ~17% more at C=6,
    for a P·(C+4) HLO count instead of P²).
    """
    B = chol.block
    P = len(chol.panels)
    Np = chol.padded_n
    Ld = _dense_lower(chol.panels, B, Np)
    T = jnp.zeros((Np, Np), jnp.float32)
    T = jax.lax.dynamic_update_slice(T, chol.linvs[0], (0, 0))
    for i in range(1, P):
        Lrow = Ld[i * B : (i + 1) * B, : i * B]  # (B, iB)
        C = min(chunks, i)
        bounds = [round(i * t / C) for t in range(C + 1)]
        accs = []
        for t in range(C):
            c0, c1 = bounds[t], bounds[t + 1]
            if c1 == c0:
                continue
            accs.append(_dot(
                Lrow[:, c0 * B :], T[c0 * B : i * B, c0 * B : c1 * B], precision
            ))
        acc = jnp.concatenate(accs, axis=1) if len(accs) > 1 else accs[0]
        Ti = -_dot(chol.linvs[i], acc, precision)
        T = jax.lax.dynamic_update_slice(T, Ti, (i * B, 0))
        T = jax.lax.dynamic_update_slice(T, chol.linvs[i], (i * B, i * B))
    return [T[s * B :, s * B : (s + 1) * B] for s in range(P)]


def kinv_panels(
    chol: BlockedCholesky,
    precision=_HIGHEST,
    tinv: Optional[Sequence[Array]] = None,
    chunks: int = 6,
) -> list:
    """K⁻¹ = L⁻ᵀ L⁻¹ as lower-triangle column panels.

    One GEMM per (column panel, row chunk) against the dense T — column
    panel s rows [r0, Np) are ``T[r0:, r0:r1]ᵀ @ T[r0:, s-panel]`` (rows of
    T above r0 are exactly zero in those columns), so the HLO count is
    P·chunks instead of the block-pair form's P²/2, at ~(C+1)/C of its
    N³/6 FLOPs.
    """
    if tinv is None:
        tinv = tri_inverse_panels(chol, precision, chunks=chunks)
    B = chol.block
    P = len(chol.panels)
    Np = chol.padded_n
    Td = _dense_lower(tinv, B, Np)
    out = []
    for s in range(P):
        rows_p = P - s
        C = min(chunks, rows_p)
        bounds = [s + round(rows_p * t / C) for t in range(C + 1)]
        blocks = []
        for t in range(C):
            r0, r1 = bounds[t], bounds[t + 1]
            if r1 == r0:
                continue
            blocks.append(_dot(
                Td[r0 * B :, r0 * B : r1 * B].T,
                Td[r0 * B :, s * B : (s + 1) * B],
                precision,
            ))
        out.append(jnp.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0])
    return out


# ---------------------------------------------------------------------------
# LML value + closed-form hyperparameter gradient
# ---------------------------------------------------------------------------


def _pad_z(X: Array, ls: Array, Np: int) -> Array:
    """ℓ-scaled inputs padded with far pseudo-points (matches
    :func:`~.blocked_chol.stationary_gram_panels`)."""
    n, D = X.shape
    Z = (X / ls).astype(jnp.float32)
    if Np > n:
        far = 1e6 * (1.0 + jnp.arange(Np - n, dtype=jnp.float32))[:, None]
        Z = jnp.concatenate([Z, jnp.broadcast_to(far, (Np - n, D))], 0)
    return Z


def _lml_forward(
    X: Array,
    Y2: Array,
    family: str,
    amp: Array,
    ls: Array,
    noise: Array,
    jitter: float,
    block: int,
    precision,
    refine_iters: int,
):
    """Shared forward: panels → factor → α (+refinement) → LML value."""
    n = X.shape[0]
    p_out = Y2.shape[1]
    panels, _ = stationary_gram_panels(
        X, ls, amp, noise + jitter, block, precision, family
    )
    chol = cholesky_panels(panels, n, precision)
    Yf = Y2.astype(jnp.float32)
    alpha = chol.solve(Yf, precision)
    for _ in range(refine_iters):
        resid = Yf - symmetric_matvec_panels(panels, alpha, n, _HIGHEST)
        alpha = alpha + chol.solve(resid, precision)
    quad = jnp.sum(Yf * alpha)
    val = -0.5 * quad - p_out * (0.5 * chol.logdet() + 0.5 * n * _LOG_2PI)
    return val, chol, alpha


def _lml_gradient(
    X: Array,
    family: str,
    amp: Array,
    ls: Array,
    noise: Array,
    chol: BlockedCholesky,
    alpha: Array,
    p_out: int,
    precision,
) -> Tuple[Array, Array, Array]:
    """(∂LML/∂log amp, ∂LML/∂log ℓ, ∂LML/∂log σ²) via the trace identity.

    W = ½(ααᵀ − P·K⁻¹) is formed panel-by-panel (never dense), weighted 2×
    on strictly-sub-diagonal blocks (each stored once, counted twice by
    symmetry) and masked off the padding rows; ∂K/∂θ is rebuilt elementwise
    per panel from X — one fused elementwise pass per θ component.
    """
    n, D = X.shape
    B = chol.block
    P = len(chol.panels)
    Np = chol.padded_n

    kinv = kinv_panels(chol, precision)
    Z = _pad_z(X, ls, Np)
    pad = Np - n
    a_p = alpha.astype(jnp.float32)
    if pad:
        a_p = jnp.concatenate([a_p, jnp.zeros((pad, a_p.shape[1]), jnp.float32)], 0)

    g_amp = jnp.zeros((), jnp.float32)
    g_ls = jnp.zeros((D,), jnp.float32)
    g_noise = jnp.zeros((), jnp.float32)
    for k in range(P):
        H = Np - k * B
        rows_g = k * B + jnp.arange(H)[:, None]
        cols_g = k * B + jnp.arange(B)[None, :]
        # symmetry weights: diag block counted once, sub-diagonal rows twice
        w = jnp.where(rows_g < (k + 1) * B, 1.0, 2.0)
        w = jnp.where((rows_g < n) & (cols_g < n), w, 0.0)
        # ααᵀ block — p_out ≤ 8 outer products unrolled elementwise
        a_rows = a_p[k * B :]
        a_cols = a_p[k * B : (k + 1) * B]
        Gk = jnp.zeros((H, B), jnp.float32)
        for p in range(a_p.shape[1]):
            Gk = Gk + a_rows[:, p, None] * a_cols[None, :, p]
        Wk = (0.5 * (Gk - p_out * kinv[k])) * w
        # rebuild ∂K/∂θ elementwise for this panel
        rowsZ = Z[k * B :]
        colsZ = Z[k * B : (k + 1) * B]
        d2 = jnp.zeros((H, B), jnp.float32)
        for d in range(D):
            diff = rowsZ[:, d, None] - colsZ[None, :, d]
            d2 = d2 + diff * diff
        g_amp = g_amp + jnp.sum(Wk * (amp * stationary_from_sqdist(d2, family)))
        dk = amp * stationary_dk_dd2(d2, family)
        Wdk = Wk * dk
        for d in range(D):
            diff = rowsZ[:, d, None] - colsZ[None, :, d]
            g_ls = g_ls.at[d].add(jnp.sum(Wdk * (-2.0 * diff * diff)))
        g_noise = g_noise + noise * jnp.sum(jnp.diagonal(Wk[:B]))
    return g_amp, g_ls, g_noise


def blocked_lml_value_and_grad(
    X: Array,
    Y: Array,
    family: str,
    log_amp: Array,
    log_ls: Array,
    log_noise: Array,
    jitter: float = 1e-6,
    block: int = 512,
    precision=_HIGHEST,
    refine_iters: int = 1,
):
    """(LML, (∂/∂log amp, ∂/∂log ℓ, ∂/∂log σ²)) — everything blocked.

    Total cost ≈ 3·N³/3 GEMM FLOPs (factor + L⁻¹ + K⁻¹) regardless of the
    number of hyperparameters, plus O(N²·D) elementwise work.
    """
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    amp = jnp.exp(log_amp).astype(jnp.float32)
    ls = jnp.exp(jnp.atleast_1d(log_ls)).astype(jnp.float32)
    noise = jnp.exp(log_noise).astype(jnp.float32)
    val, chol, alpha = _lml_forward(
        X, Y2, family, amp, ls, noise, jitter, block, precision, refine_iters,
    )
    grads = _lml_gradient(
        X, family, amp, ls, noise, chol, alpha, Y2.shape[1], precision
    )
    return val, grads


def make_blocked_lml(
    family: str,
    jitter: float = 1e-6,
    block: int = 512,
    precision=_HIGHEST,
    refine_iters: int = 1,
):
    """Build ``lml(theta, X, Y) -> scalar`` with a closed-form custom VJP.

    ``theta`` is the dict ``{'log_amp': (), 'log_ls': (D,), 'log_noise': ()}``.
    Reverse-mode never touches the factorization: the VJP runs the panel
    trace-identity gradient above.  X/Y cotangents are not propagated
    (hyperparameter optimization holds the data fixed).
    """

    def _fwd_impl(theta, X, Y):
        Y2 = Y if Y.ndim == 2 else Y[:, None]
        amp = jnp.exp(theta["log_amp"]).astype(jnp.float32)
        ls = jnp.exp(jnp.atleast_1d(theta["log_ls"])).astype(jnp.float32)
        noise = jnp.exp(theta["log_noise"]).astype(jnp.float32)
        val, chol, alpha = _lml_forward(
            X, Y2, family, amp, ls, noise, jitter, block, precision,
            refine_iters,
        )
        return val, (theta, X, Y, chol, alpha)

    @jax.custom_vjp
    def lml(theta, X, Y):
        return _fwd_impl(theta, X, Y)[0]

    def fwd(theta, X, Y):
        return _fwd_impl(theta, X, Y)

    def bwd(res, g):
        theta, X, Y, chol, alpha = res
        amp = jnp.exp(theta["log_amp"]).astype(jnp.float32)
        ls = jnp.exp(jnp.atleast_1d(theta["log_ls"])).astype(jnp.float32)
        noise = jnp.exp(theta["log_noise"]).astype(jnp.float32)
        g_amp, g_ls, g_noise = _lml_gradient(
            X, family, amp, ls, noise, chol, alpha, alpha.shape[1], precision
        )
        # isotropic ℓ (one shared log ℓ over D input dims): chain-rule sum
        ls_shape = jnp.shape(theta["log_ls"])
        ls_size = math.prod(ls_shape) if ls_shape else 1
        if ls_size == 1 and g_ls.shape[0] > 1:
            g_ls = jnp.sum(g_ls)
        g_theta = {
            "log_amp": (g_amp * g).astype(jnp.asarray(theta["log_amp"]).dtype),
            "log_ls": (g_ls * g).reshape(ls_shape).astype(
                jnp.asarray(theta["log_ls"]).dtype
            ),
            "log_noise": (g_noise * g).astype(jnp.asarray(theta["log_noise"]).dtype),
        }
        # dLML/dY = −K⁻¹Y = −α — free given the residuals
        gY = jnp.reshape(-alpha * g, jnp.shape(Y)).astype(Y.dtype)
        return g_theta, jnp.zeros_like(X), gY

    lml.defvjp(fwd, bwd)
    return lml
