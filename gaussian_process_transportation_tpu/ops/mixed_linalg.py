"""Mixed-precision blocked Cholesky + iterative-refinement GP solves.

Experimental large-N exact-GP path with no production caller (reference
scale driver: ``policy_transportation/models/gaussian_process_al.py:16``
caps exact GPs at N=20000; SURVEY.md §5 names the Gram dimension N as this
framework's scaling axis).  A reduced-precision matmul mode runs several
times faster than float32-accurate ("highest") matmuls; to put the
O(N³/3) trailing-update FLOPs of a Cholesky on that mode, the blocking is
owned here:

- ``blocked_cholesky``: right-looking blocked factorization, unrolled over
  static panels inside one jit.  The diagonal-block factorizations (small,
  O(N·B²) total) use the built-in kernel at full accuracy; the panel solve
  is a triangular solve against the diagonal block; the trailing SYRK —
  ~all the FLOPs — is an explicit ``dot`` whose precision the caller picks
  (``jax.lax.Precision.DEFAULT`` = the platform's fastest f32 mode).

- ``pcg_solve``: solves K x = B by conjugate gradients preconditioned with
  the low-precision factor, residual matmuls at full f32 accuracy.  Plain
  fixed-point refinement x ← x + (LLᵀ)⁻¹(B − Kx) needs κ(K)·u_bf16 < 1 and
  GP Grams routinely violate it (measured: κ≈1.7e3, contraction ρ≈2.6);
  CG only needs LLᵀ to be SPD and spectrally close, and converges at
  √κ((LLᵀ)⁻¹K) ≪ √κ(K).  This is the GMRES/CG-based flavor of
  Higham-Pranesh mixed-precision iterative refinement.  ``ir_solve`` (the cheap fixed-point sweep) remains for
  well-conditioned systems.

The GP conditioning entry point is ``gram_chol_solve_mixed`` — build the
Gram at full accuracy (O(N²D), cheap), factor with bf16 SYRK, refine.
Numerical safety: RBF-family Grams carry a White-noise diagonal; the
factorization adds no implicit regularization, and callers verify the
refined residual (returned) instead of trusting the factor.  NaN anywhere
→ callers fall back to ``ops.linalg`` full-precision paths.

Status: not measured on the GPU; the builtin ``jnp.linalg.cholesky``
remains the default everywhere.  This module's value is PCG refinement
for solves whose factor is approximate for ANY reason (low precision,
stale factor after a rank-update, cross-device partial factors).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .linalg import add_diagonal

Array = jax.Array


def _precision(p) -> jax.lax.Precision:
    if isinstance(p, jax.lax.Precision):
        return p
    return {
        "default": jax.lax.Precision.DEFAULT,
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
    }[p]


def blocked_cholesky(
    K: Array,
    block: int = 1024,
    syrk_precision="default",
    emulate_bf16: bool = False,
) -> Array:
    """Lower Cholesky of a PSD matrix with caller-controlled trailing-update
    precision.

    ``emulate_bf16`` rounds the panel through bfloat16 before the trailing
    update so CPU tests exercise a low-precision error profile (CPU
    ignores ``Precision``).
    """
    n = K.shape[-1]
    if n <= block:
        return jnp.linalg.cholesky(K)
    prec = _precision(syrk_precision)
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        # pad with identity so the factorization stays well-posed
        Kp = jnp.zeros((n + pad, n + pad), K.dtype)
        Kp = Kp.at[:n, :n].set(K)
        idx = jnp.arange(n, n + pad)
        Kp = Kp.at[idx, idx].set(1.0)
        K = Kp
    n_p = nb * block

    A = K
    L = jnp.zeros_like(A)
    for kb in range(nb):
        s = kb * block
        e = s + block
        Akk = A[s:e, s:e]
        Lkk = jnp.linalg.cholesky(Akk)
        L = L.at[s:e, s:e].set(Lkk)
        if e == n_p:
            break
        # panel: L21 = A21 · L11⁻ᵀ  (trsm on the B×B diagonal block)
        A21 = A[e:, s:e]
        L21 = jax.scipy.linalg.solve_triangular(Lkk, A21.T, lower=True).T
        L = L.at[e:, s:e].set(L21)
        # trailing SYRK — the O(N³/3) FLOPs — at the chosen precision
        P = L21.astype(jnp.bfloat16).astype(L21.dtype) if emulate_bf16 else L21
        A = A.at[e:, e:].add(-jnp.dot(P, P.T, precision=prec))
    return L[:n, :n] if pad else L


def ir_solve(
    K: Array,
    L: Array,
    B: Array,
    sweeps: int = 3,
    residual_precision="highest",
) -> Tuple[Array, Array]:
    """Solve K x = B by iterative refinement preconditioned with the
    (approximate) lower Cholesky factor L.

    Returns ``(x, rel_residual)`` where ``rel_residual`` is
    ‖B − K x‖_F / ‖B‖_F evaluated at the returned iterate — callers gate
    on it rather than trusting the factor's precision.
    """
    prec = _precision(residual_precision)

    def cho(b):
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    x = cho(B)
    for _ in range(sweeps):
        r = B - jnp.dot(K, x, precision=prec)
        x = x + cho(r)
    r = B - jnp.dot(K, x, precision=prec)
    rel = jnp.linalg.norm(r) / jnp.maximum(jnp.linalg.norm(B), 1e-30)
    return x, rel


def pcg_solve(
    K: Array,
    L: Array,
    B: Array,
    iters: int = 24,
    residual_precision="highest",
) -> Tuple[Array, Array]:
    """Solve K x = B (multi-RHS, columns independent) by preconditioned CG
    with M = (L Lᵀ)⁻¹ as the preconditioner.

    Static iteration count (jit-friendly: no data-dependent exit);
    returns ``(x, rel_residual)`` with rel_residual = ‖B − Kx‖_F/‖B‖_F for
    the caller to gate on.  Per-iteration cost is one K·p matmul (O(N²·P))
    + two triangular solves — negligible next to the O(N³) factorization.
    """
    prec = _precision(residual_precision)

    def cho(b):
        y = jax.scipy.linalg.solve_triangular(L, b, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)

    def col_dot(a, b):  # per-column inner products, shape (P,)
        return jnp.sum(a * b, axis=0)

    x = jnp.zeros_like(B)
    r = B
    z = cho(r)
    p = z
    rz = col_dot(r, z)

    def body(carry, _):
        x, r, p, rz = carry
        Kp = jnp.dot(K, p, precision=prec)
        denom = col_dot(p, Kp)
        # guards must not use a literal that underflows in f32 (1e-300 → 0)
        alpha = jnp.where(denom > 0, rz / jnp.where(denom > 0, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Kp
        z = cho(r)
        rz_new = col_dot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, r, _, _), _ = jax.lax.scan(body, (x, r, p, rz), None, length=iters)
    # per-column relative residual, reduced by max so one badly converged
    # RHS column cannot hide behind well-converged ones when callers gate
    resid = B - jnp.dot(K, x, precision=prec)
    rel = jnp.max(
        jnp.linalg.norm(resid, axis=0)
        / jnp.maximum(jnp.linalg.norm(B, axis=0), 1e-30)
    )
    return x, rel


def gram_chol_solve_mixed(
    kernel,
    X: Array,
    Y: Array,
    jitter: float = 1e-6,
    block: int = 1024,
    syrk_precision="default",
    iters: int = 24,
    emulate_bf16: bool = False,
) -> Tuple[Array, Array, Array]:
    """Large-N GP conditioning: Gram (full accuracy) → mixed-precision
    blocked Cholesky → PCG-refined solve.  Returns ``(alpha, L, rel_residual)``.

    **Status: experimental, no production caller.**  The production
    large-N paths are ``models.exact_gp.condition`` and
    ``ops.blocked_chol.gram_cholesky_solve``.  What remains useful here is
    the PCG refinement: ``alpha``
    is refined to full working precision and certified by
    ``rel_residual`` (max over RHS columns).

    ``L`` is the *low-precision* factor used only as the PCG
    preconditioner — it carries bf16-scale error and must NOT be used for
    predictive variance or log-determinants without its own refinement.
    """
    Km = add_diagonal(kernel(X), jitter)
    L = blocked_cholesky(
        Km, block=block, syrk_precision=syrk_precision, emulate_bf16=emulate_bf16
    )
    alpha, rel = pcg_solve(Km, L, Y, iters=iters)
    return alpha, L, rel
