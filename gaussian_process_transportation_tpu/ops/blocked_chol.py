"""Blocked Cholesky in column-panel form — the large-N exact-GP path.

The matrix is held as a list of *lower-triangle column panels*
``panels[k] : (N - k·B, B)`` plus the inverse of every (B, B) diagonal
block.  With the diagonal-block inverses in hand the outer algorithms need
no triangular solves of their own:

* TRSM (panel below the diagonal)   → one GEMM against L_kk⁻ᵀ,
* trailing update                   → one history GEMM per panel,
* forward/backward substitution     → blocked GEMMs with the retained
                                      diagonal-block inverses.

Each diagonal block is factored by :func:`factor_panel` — XLA's Cholesky
(cuSOLVER ``potrf`` on a GPU) and a triangular solve against the identity
for L_kk⁻¹.  The panel form is what ``models.exact_gp.condition_blocked``,
``ops.blocked_lml`` (large-N hyperparameter fits) and the multi-device
``parallel.sharded_{chol,lml}`` consume; a single conditioning
(``models.exact_gp.condition``) is one dense ``jnp.linalg.cholesky``,
which was faster on the H100 (``PERF.md``).

Reference workloads: the N=2500 surface Gram of
``example/3D/surface_generalization_3D.py:50-51`` and the 20 000-point
active-learning cap of ``models/gaussian_process_al.py:16``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

_HIGHEST = jax.lax.Precision.HIGHEST


def _dot(a: Array, b: Array, precision) -> Array:
    return jnp.dot(a, b, preferred_element_type=jnp.float32, precision=precision)


@jax.jit
def factor_panel(A: Array) -> Tuple[Array, Array]:
    """(L, L⁻¹) of one (B, B) SPD block: XLA Cholesky, then a triangular
    solve of L against the identity."""
    A = A.astype(jnp.float32)
    L = jnp.linalg.cholesky(A)
    eye = jnp.eye(A.shape[0], dtype=jnp.float32)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return L, Linv


# ---------------------------------------------------------------------------
# Outer blocked algorithm on lower-triangle column panels
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
class BlockedCholesky:
    """Lower Cholesky factor held as column panels + diag-block inverses.

    ``panels[k]`` is the (N − k·B, B) slice of L below and including the
    k-th diagonal block; ``linvs`` is (P, B, B) with L_kk⁻¹.  ``n`` is the
    logical (unpadded) dimension — rows/cols beyond it factor an identity
    padding block and are sliced away by :meth:`solve`.
    """

    def __init__(self, panels: Sequence[Array], linvs: Array, n: int):
        self.panels = tuple(panels)
        self.linvs = linvs
        self.n = n

    @property
    def block(self) -> int:
        return self.panels[0].shape[1]

    @property
    def padded_n(self) -> int:
        return self.panels[0].shape[0]

    def tree_flatten(self):
        return (self.panels, self.linvs), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        panels, linvs = children
        return cls(panels, linvs, aux[0])

    # -- dense reconstruction (tests / small N only) ----------------------
    def dense(self) -> Array:
        Np, B = self.padded_n, self.block
        L = jnp.zeros((Np, Np), jnp.float32)
        for k, p in enumerate(self.panels):
            L = L.at[k * B :, k * B : (k + 1) * B].set(p)
        return L[: self.n, : self.n]

    def logdet(self) -> Array:
        """log det K = 2 Σ log diag(L), padding blocks excluded."""
        B = self.block
        total = jnp.asarray(0.0, jnp.float32)
        for k, p in enumerate(self.panels):
            d = jnp.diagonal(p[:B])
            idx = k * B + jnp.arange(B)
            total = total + jnp.sum(jnp.where(idx < self.n, jnp.log(d), 0.0))
        return 2.0 * total

    def _pad_rhs(self, b: Array):
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        pad = self.padded_n - b.shape[0]
        if pad:
            b = jnp.concatenate(
                [b, jnp.zeros((pad, b.shape[1]), b.dtype)], axis=0
            )
        return b.astype(jnp.float32), squeeze

    def _forward(self, b: Array, precision) -> list:
        """y = L⁻¹ b, right-looking: ONE shrinking GEMM per panel (the whole
        sub-diagonal panel hits the remaining RHS at once) instead of
        P²/2 block-by-block updates."""
        B = self.block
        ys = []
        rest = b
        for k, p in enumerate(self.panels):
            yk = _dot(self.linvs[k], rest[:B], precision)
            ys.append(yk)
            if p.shape[0] > B:
                rest = rest[B:] - _dot(p[B:], yk, precision)
        return ys

    def solve(self, b: Array, precision=_HIGHEST) -> Array:
        """(L Lᵀ)⁻¹ b by blocked substitution — GEMMs against the retained
        diag-block inverses instead of triangular-solve custom calls.
        2P GEMMs total (one per panel per sweep)."""
        B = self.block
        P = len(self.panels)
        b, squeeze = self._pad_rhs(b)
        ys = self._forward(b, precision)
        # backward: x_j = L_jj⁻ᵀ (y_j − panels[j][B:]ᵀ · x_below)
        nrhs = b.shape[1]
        below = jnp.zeros((0, nrhs), jnp.float32)
        xs: list = [None] * P
        for j in reversed(range(P)):
            s = ys[j]
            if below.shape[0]:
                s = s - _dot(self.panels[j][B:].T, below, precision)
            xs[j] = _dot(self.linvs[j].T, s, precision)
            below = jnp.concatenate([xs[j], below], axis=0)
        x = below[: self.n]
        return x[:, 0] if squeeze else x

    def solve_lower(self, b: Array, precision=_HIGHEST) -> Array:
        """L⁻¹ b (forward substitution only) — e.g. for whitening k*."""
        b, squeeze = self._pad_rhs(b)
        y = jnp.concatenate(self._forward(b, precision), axis=0)[: self.n]
        return y[:, 0] if squeeze else y


def _split_panels(K: Array, B: int, n: int, diag_pad: float = 1.0) -> list:
    """Lower-triangle column panels of K padded to a multiple of B with an
    identity-scaled diagonal block (padding never couples to real rows)."""
    Np = -(-n // B) * B
    pad = Np - n
    if pad:
        K = jnp.pad(K.astype(jnp.float32), ((0, pad), (0, pad)))
        idx = n + jnp.arange(pad)
        K = K.at[idx, idx].set(diag_pad)
    return [K[k * B :, k * B : (k + 1) * B] for k in range(Np // B)]


def cholesky_panels(
    panels: Sequence[Array],
    n: int,
    precision=_HIGHEST,
) -> BlockedCholesky:
    """LEFT-looking blocked Cholesky over lower-triangle column panels.

    The Python loop over the P panels is unrolled at trace time, so every
    GEMM has a static shape; each panel applies its whole history
    correction as ONE (Np−kB, kB)·(kB, B) GEMM against the dense lower
    factor accumulated so far — 3 HLOs per panel, O(P) total, N³/3 FLOPs.
    ``precision`` applies to the history and TRSM GEMMs.
    """
    B = panels[0].shape[1]
    P = len(panels)
    Np = panels[0].shape[0]
    # dense lower accumulator for the history GEMMs; every panel writes its
    # slice exactly once, so XLA updates it in place
    Ldense = jnp.zeros((Np, Np), jnp.float32)
    L_panels: list = [None] * P
    linvs: list = [None] * P
    for k in range(P):
        pk = panels[k].astype(jnp.float32)
        if k:
            hist = Ldense[k * B :, : k * B]                 # (Np−kB, kB)
            hist_k = Ldense[k * B : (k + 1) * B, : k * B]   # (B, kB)
            pk = pk - _dot(hist, hist_k.T, precision)
        Lkk, Linv = factor_panel(pk[:B])
        linvs[k] = Linv
        if pk.shape[0] > B:
            below = _dot(pk[B:], Linv.T, precision)  # TRSM as GEMM
            Lk = jnp.concatenate([Lkk, below], axis=0)
        else:
            Lk = Lkk
        L_panels[k] = Lk
        if k + 1 < P:
            Ldense = jax.lax.dynamic_update_slice(Ldense, Lk, (k * B, k * B))
    return BlockedCholesky(L_panels, jnp.stack(linvs), n)


def blocked_cholesky(
    K: Array,
    block: int = 512,
    precision=_HIGHEST,
) -> BlockedCholesky:
    """Blocked Cholesky of a dense SPD K (N, N); N need not divide block."""
    n = K.shape[0]
    B = min(block, n)
    return cholesky_panels(_split_panels(K, B, n), n, precision)


# Stationary covariance families on scaled squared distance d² — shared by
# the panel Gram builders here and in ``parallel/sharded_chol.py``.  The
# reference's canonical policy-DS kernel is C*Matern(ν=2.5)+White
# (example/2D/surface_generalization.py:49), so the panel paths cover the
# Matern family, not just RBF.
STATIONARY_FAMILIES = ("rbf", "matern12", "matern32", "matern52")

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def stationary_from_sqdist(d2: Array, family: str) -> Array:
    """k(d²) for a unit-amplitude stationary family on ℓ-scaled inputs."""
    if family == "rbf":
        return jnp.exp(-0.5 * d2)
    d = jnp.sqrt(d2 + 1e-36)
    if family == "matern12":
        return jnp.exp(-d)
    if family == "matern32":
        s = _SQRT3 * d
        return (1.0 + s) * jnp.exp(-s)
    if family == "matern52":
        s = _SQRT5 * d
        return (1.0 + s + s * s / 3.0) * jnp.exp(-s)
    raise ValueError(f"unknown stationary family {family!r}")


def stationary_gram_panels(
    X: Array,
    lengthscale: Array,
    amplitude,
    noise,
    block: int,
    precision=_HIGHEST,
    family: str = "rbf",
) -> Tuple[list, int]:
    """Lower-triangle column panels of amp·k((x−x′)/ℓ) + noise·I for any
    stationary family, built panel-by-panel — the full (N, N) Gram never
    exists in device memory.

    Padding rows use far-away pseudo-points so their off-diagonal kernel
    values underflow to 0; their diagonal is amp+noise (a positive block
    the factorization consumes and :meth:`BlockedCholesky.solve` ignores).
    """
    n, D = X.shape
    Np = -(-n // block) * block
    ls = jnp.atleast_1d(jnp.asarray(lengthscale)).astype(jnp.float32)
    Z = (X / ls).astype(jnp.float32)
    if Np > n:
        far = 1e6 * (1.0 + jnp.arange(Np - n, dtype=jnp.float32))[:, None]
        Z = jnp.concatenate([Z, jnp.broadcast_to(far, (Np - n, D))], 0)
    amp = jnp.asarray(amplitude, jnp.float32)
    noise = jnp.asarray(noise, jnp.float32)
    panels = []
    for k in range(Np // block):
        rows = Z[k * block :]  # (M_k, D)
        cols = Z[k * block : (k + 1) * block]  # (B, D)
        # d² as per-dimension broadcast differences, unrolled over the small
        # D: one elementwise fusion writing (M_k, B), exact in f32
        d2 = jnp.zeros((rows.shape[0], block), jnp.float32)
        for dim in range(D):
            diff = rows[:, dim, None] - cols[None, :, dim]
            d2 = d2 + diff * diff
        p = amp * stationary_from_sqdist(d2, family)
        ridx = jnp.arange(p.shape[0])[:, None]
        cidx = jnp.arange(block)[None, :]
        p = jnp.where(ridx == cidx, p + noise, p)
        panels.append(p)
    return panels, n


def rbf_gram_panels(X, lengthscale, amplitude, noise, block, precision=_HIGHEST):
    """Back-compat alias: RBF panels (see :func:`stationary_gram_panels`)."""
    return stationary_gram_panels(
        X, lengthscale, amplitude, noise, block, precision, family="rbf"
    )


def symmetric_matvec_panels(panels: Sequence[Array], x: Array, n: int,
                            precision=_HIGHEST) -> Array:
    """K @ x from lower-triangle column panels of a symmetric K.

    Per panel k: the stored block column contributes P_k · x_k to rows
    k·B…, and its strict sub-diagonal part contributes P_k[B:]ᵀ · x_below
    to rows of block k (the mirrored upper triangle)."""
    B = panels[0].shape[1]
    Np = panels[0].shape[0]
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    pad = Np - x.shape[0]
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, x.shape[1]), x.dtype)], axis=0)
    x = x.astype(jnp.float32)
    y = jnp.zeros_like(x)
    for k, p in enumerate(panels):
        xk = x[k * B : (k + 1) * B]
        y = y.at[k * B :].add(_dot(p, xk, precision))
        if p.shape[0] > B:
            up = _dot(p[B:].T, x[(k + 1) * B :], precision)
            y = y.at[k * B : (k + 1) * B].add(up)
    y = y[:n]
    return y[:, 0] if squeeze else y


def gram_cholesky_solve(
    X: Array,
    Y: Array,
    lengthscale: Array,
    amplitude,
    noise,
    block: int = 512,
    precision=_HIGHEST,
    refine_iters: int = 1,
    family: str = "rbf",
) -> Tuple[Array, BlockedCholesky]:
    """Fused K=k(X,X)+σ²I → blocked Cholesky → α = K⁻¹Y.

    Gram panels are built elementwise, TRSM/history updates are GEMMs,
    each diagonal block goes through :func:`factor_panel`, and the solve
    is blocked substitution with the retained diag-block inverses.

    ``refine_iters`` steps of f32 iterative refinement
    (α ← α + K⁻¹(Y − Kα), residual at HIGHEST precision) bring the solve
    back to plain-f32 accuracy when the GEMMs ran at a lower precision.
    """
    panels, n = stationary_gram_panels(
        X, lengthscale, amplitude, noise, block, precision, family
    )
    chol = cholesky_panels(panels, n, precision)
    squeeze = Y.ndim == 1
    Y2 = Y[:, None] if squeeze else Y
    alpha = chol.solve(Y2, precision)
    for _ in range(refine_iters):
        resid = Y2.astype(jnp.float32) - symmetric_matvec_panels(
            panels, alpha, n, _HIGHEST
        )
        alpha = alpha + chol.solve(resid, precision)
    return (alpha[:, 0] if squeeze else alpha), chol
