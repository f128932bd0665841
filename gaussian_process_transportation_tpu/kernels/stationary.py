"""Stationary covariance kernels as JAX pytrees.

Design notes:

* A kernel is an immutable pytree dataclass (``utils.pytree``) whose *array leaves are
  the hyperparameters*.  ``jax.grad`` with respect to the kernel object
  therefore differentiates the Gram matrix w.r.t. the hyperparameters with no
  extra plumbing, and ``vmap`` over a batch of kernels gives batched
  (ensemble / multi-restart) Gram construction for free.
* Gram matrices are built with the ``||x||^2 + ||z||^2 - 2 x.z`` expansion so
  the O(N^2 D) work is a single matmul.  (The
  reference uses sklearn's pairwise distances on CPU:
  ``policy_transportation/models/gaussian_process.py:42``.)
* ``theta`` exposes the hyperparameters as a flat log-space vector with
  sklearn-compatible ordering (left-to-right flattening of Sum/Product
  trees), so the L-BFGS hyperoptimizer reproduces
  ``sklearn.gaussian_process`` fit semantics (see
  ``policy_transportation/models/gaussian_process.py:17-21`` in the
  reference).
* First/second input-derivatives of the kernel (needed for the transport
  Jacobian posterior, reference ``gaussian_process.py:63-101``) are provided
  closed-form for RBF-family kernels and via ``jax.jacfwd`` generically.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

Array = jax.Array

DEFAULT_BOUNDS = (1e-5, 1e5)


def _sqdist(X: Array, Z: Array) -> Array:
    """Pairwise squared Euclidean distances.

    For the small input dimensions of this domain (D ≤ 8: 2D/3D poses,
    quaternion features) D unrolled differences fuse into one elementwise
    pass and are exact (no x²−2xz+z² cancellation, which on
    workspace-scale coordinates |x|~50 can break positive-definiteness);
    a matmul expansion would contract over a tiny K=D.

    Larger D falls back to the matmul expansion at HIGHEST precision
    (reduced-precision passes corrupt the Gram)."""
    D = X.shape[-1]
    if D <= 8:
        d2 = None
        for d in range(D):
            diff = X[..., :, None, d] - Z[..., None, :, d]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        return d2
    xx = jnp.sum(X * X, axis=-1)[..., :, None]
    zz = jnp.sum(Z * Z, axis=-1)[..., None, :]
    xz = jnp.matmul(X, jnp.swapaxes(Z, -1, -2), precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(xx + zz - 2.0 * xz, 0.0)


class Kernel:
    """Base: operator overloading + theta (log-space flat params) protocol."""

    # ---- composition -----------------------------------------------------
    def __add__(self, other):
        return Sum(k1=self, k2=_as_kernel(other))

    def __radd__(self, other):
        return Sum(k1=_as_kernel(other), k2=self)

    def __mul__(self, other):
        return Product(k1=self, k2=_as_kernel(other))

    def __rmul__(self, other):
        return Product(k1=_as_kernel(other), k2=self)

    # ---- evaluation ------------------------------------------------------
    def __call__(self, X: Array, Z: Optional[Array] = None) -> Array:
        raise NotImplementedError

    def diag(self, X: Array) -> Array:
        return jnp.diagonal(self(X, X))

    # ---- flat log-parameter vector ---------------------------------------
    @property
    def theta(self) -> Array:
        leaves = jax.tree_util.tree_leaves(self)
        if not leaves:
            return jnp.zeros((0,))
        return jnp.log(jnp.concatenate([jnp.atleast_1d(l) for l in leaves]))

    def with_theta(self, theta: Array) -> "Kernel":
        leaves, treedef = jax.tree_util.tree_flatten(self)
        new_leaves = []
        i = 0
        for leaf in leaves:
            leaf = jnp.asarray(leaf)
            n = leaf.size
            seg = jnp.exp(theta[i : i + n]).reshape(leaf.shape).astype(leaf.dtype)
            new_leaves.append(seg)
            i += n
        return jax.tree_util.tree_unflatten(treedef, new_leaves)

    @property
    def n_theta(self) -> int:
        return sum(jnp.asarray(l).size for l in jax.tree_util.tree_leaves(self))

    @property
    def theta_bounds(self) -> Array:
        """(n_theta, 2) array of log-space bounds, sklearn ordering."""
        bounds = []
        self._collect_bounds(bounds)
        if not bounds:
            return jnp.zeros((0, 2))
        return jnp.log(jnp.asarray(bounds))

    def _collect_bounds(self, out: list) -> None:
        raise NotImplementedError

    # ---- pointwise form (autodiff-exact, no matmul-expansion clamp) ------
    def pairwise(self, a: Array, b: Array) -> Array:
        """k(a, b) for single points a, b of shape (D,) as a scalar.

        Written with explicit differences (not the ||a||²+||b||²−2a·b
        expansion), so autodiff through it is exact even at a == b where
        the clamped expansion mis-splits gradients at the tie.  Cross-
        covariance semantics: White contributes zero.
        """
        raise NotImplementedError

    # ---- derivatives wrt the first input ---------------------------------
    def dx(self, x: Array, Z: Array) -> Array:
        """∂k(x_i, Z_j)/∂x_i with shape (N, M, D).

        Generic path: forward-mode through the pointwise form.  Subclasses
        with closed forms override.
        """

        def row(xi):
            return jax.vmap(lambda zj: self.pairwise(xi, zj))(Z)

        return jax.vmap(jax.jacfwd(row))(x)

    def dxdz_diag(self, x: Array) -> Array:
        """diag_d ∂²k(a,b)/∂a_d∂b_d evaluated at a=b=x_i; shape (N, D).

        This is the prior variance of the d-th partial derivative of a GP
        sample — the `prior_var/lengthscale²` term in the reference's
        Jacobian variance (``gaussian_process.py:98``).
        """

        def at_point(xi):
            H = jax.jacfwd(jax.jacrev(self.pairwise, argnums=0), argnums=1)(xi, xi)
            return jnp.diagonal(H)

        return jax.vmap(at_point)(x)

    def dxT(self, x: Array, Z: Array) -> Array:
        """∂k(x_i, Z_j)/∂x_d in query-last layout: shape (D, M, N).

        Same values as ``dx`` transposed, but subclasses build it natively
        so the large query axis stays minormost and contiguous.  Used by
        the batched transport hot path.
        """
        return jnp.transpose(self.dx(x, Z), (2, 1, 0))


def _as_kernel(x) -> Kernel:
    if isinstance(x, Kernel):
        return x
    return Constant(constant_value=jnp.asarray(x, dtype=jnp.result_type(float)))


@struct.dataclass
class Constant(Kernel):
    constant_value: Array = struct.field(default=1.0)
    bounds: Tuple[float, float] = struct.field(pytree_node=False, default=DEFAULT_BOUNDS)

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        return jnp.full((X.shape[0], Z.shape[0]), 1.0) * self.constant_value

    def diag(self, X):
        return jnp.full((X.shape[0],), 1.0) * self.constant_value

    def pairwise(self, a, b):
        return jnp.asarray(self.constant_value) * 1.0

    def dx(self, x, Z):
        return jnp.zeros((x.shape[0], Z.shape[0], x.shape[1]))

    def dxT(self, x, Z):
        return jnp.zeros((x.shape[1], Z.shape[0], x.shape[0]))

    def dxdz_diag(self, x):
        return jnp.zeros(x.shape)

    def _collect_bounds(self, out):
        out.append(self.bounds)


@struct.dataclass
class White(Kernel):
    """White noise: k(x,z) = noise_level * 1[x is z].

    Like sklearn, cross-covariance k(X, Z) with Z given is zero; only the
    self-Gram carries the noise diagonal.
    """

    noise_level: Array = struct.field(default=1.0)
    bounds: Tuple[float, float] = struct.field(pytree_node=False, default=DEFAULT_BOUNDS)

    def __call__(self, X, Z=None):
        if Z is None:
            return self.noise_level * jnp.eye(X.shape[0])
        return jnp.zeros((X.shape[0], Z.shape[0])) * self.noise_level

    def diag(self, X):
        return jnp.full((X.shape[0],), 1.0) * self.noise_level

    def pairwise(self, a, b):
        return jnp.asarray(0.0) * self.noise_level

    def dx(self, x, Z):
        return jnp.zeros((x.shape[0], Z.shape[0], x.shape[1]))

    def dxT(self, x, Z):
        return jnp.zeros((x.shape[1], Z.shape[0], x.shape[0]))

    def dxdz_diag(self, x):
        return jnp.zeros(x.shape)

    def _collect_bounds(self, out):
        out.append(self.bounds)


@struct.dataclass
class RBF(Kernel):
    """Squared-exponential with ARD lengthscales."""

    lengthscale: Array = struct.field(default=1.0)
    bounds: Tuple[float, float] = struct.field(pytree_node=False, default=DEFAULT_BOUNDS)

    def _scaled(self, X):
        ls = jnp.atleast_1d(self.lengthscale)
        return X / ls

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        d2 = _sqdist(self._scaled(X), self._scaled(Z))
        return jnp.exp(-0.5 * d2)

    def diag(self, X):
        return jnp.ones((X.shape[0],))

    def pairwise(self, a, b):
        ls = jnp.atleast_1d(self.lengthscale)
        d2 = jnp.sum(((a - b) / ls) ** 2)
        return jnp.exp(-0.5 * d2)

    def dx(self, x, Z):
        # ∂k/∂x_d = -(x_d - z_d)/ls_d² · k(x,z)
        k = self(x, Z)  # (N, M)
        ls = jnp.atleast_1d(self.lengthscale)
        diff = (Z[None, :, :] - x[:, None, :]) / (ls**2)  # (N, M, D)
        return diff * k[:, :, None]

    def dxT(self, x, Z):
        kT = self(Z, x)  # (M, N)
        ls = jnp.atleast_1d(self.lengthscale)
        diffT = (Z.T[:, :, None] - x.T[:, None, :]) / (ls**2)[:, None, None]  # (D, M, N)
        return diffT * kT[None]

    def dxdz_diag(self, x):
        ls = jnp.atleast_1d(self.lengthscale)
        return jnp.ones_like(x) / (ls**2)

    def _collect_bounds(self, out):
        n = jnp.atleast_1d(self.lengthscale).size
        out.extend([self.bounds] * n)


@struct.dataclass
class Matern(Kernel):
    """Matérn kernel, nu ∈ {0.5, 1.5, 2.5, inf} (ARD lengthscales)."""

    lengthscale: Array = struct.field(default=1.0)
    nu: float = struct.field(pytree_node=False, default=1.5)
    bounds: Tuple[float, float] = struct.field(pytree_node=False, default=DEFAULT_BOUNDS)

    def __call__(self, X, Z=None):
        Z = X if Z is None else Z
        ls = jnp.atleast_1d(self.lengthscale)
        d2 = _sqdist(X / ls, Z / ls)
        if self.nu == math.inf:
            return jnp.exp(-0.5 * d2)
        d = jnp.sqrt(d2 + 1e-36)
        if self.nu == 0.5:
            return jnp.exp(-d)
        if self.nu == 1.5:
            s = math.sqrt(3.0) * d
            return (1.0 + s) * jnp.exp(-s)
        if self.nu == 2.5:
            s = math.sqrt(5.0) * d
            return (1.0 + s + s * s / 3.0) * jnp.exp(-s)
        raise NotImplementedError(f"Matern nu={self.nu} not supported")

    def diag(self, X):
        return jnp.ones((X.shape[0],))

    def pairwise(self, a, b):
        ls = jnp.atleast_1d(self.lengthscale)
        d2 = jnp.sum(((a - b) / ls) ** 2)
        if self.nu == math.inf:
            return jnp.exp(-0.5 * d2)
        d = jnp.sqrt(d2 + 1e-36)
        if self.nu == 0.5:
            return jnp.exp(-d)
        if self.nu == 1.5:
            s = math.sqrt(3.0) * d
            return (1.0 + s) * jnp.exp(-s)
        if self.nu == 2.5:
            s = math.sqrt(5.0) * d
            return (1.0 + s + s * s / 3.0) * jnp.exp(-s)
        raise NotImplementedError(f"Matern nu={self.nu} not supported")

    def dx(self, x, Z):
        """Closed-form ∂k/∂x; smooth for nu ≥ 1.5."""
        ls = jnp.atleast_1d(self.lengthscale)
        diff = (x[:, None, :] - Z[None, :, :]) / (ls**2)  # (N,M,D)
        d2 = _sqdist(x / ls, Z / ls)
        if self.nu == math.inf:
            k = jnp.exp(-0.5 * d2)
            return -diff * k[:, :, None]
        d = jnp.sqrt(d2 + 1e-36)
        if self.nu == 1.5:
            c = 3.0 * jnp.exp(-math.sqrt(3.0) * d)
            return -diff * c[:, :, None]
        if self.nu == 2.5:
            s = math.sqrt(5.0) * d
            c = (5.0 / 3.0) * (1.0 + s) * jnp.exp(-s)
            return -diff * c[:, :, None]
        # nu = 0.5 is not differentiable at 0; use subgradient formula
        k = jnp.exp(-d)
        safe_d = jnp.maximum(d, 1e-12)
        return -diff * (k / safe_d)[:, :, None]

    def dxT(self, x, Z):
        """Query-last closed form: −coeff(x,Z)ᵀ ⊙ (x−Z)/ls² as (D, M, N)."""
        ls = jnp.atleast_1d(self.lengthscale)
        diffT = (Z.T[:, :, None] - x.T[:, None, :]) / (ls**2)[:, None, None]  # (D,M,N)
        d2T = _sqdist(Z / ls, x / ls)  # (M, N)
        if self.nu == math.inf:
            return diffT * jnp.exp(-0.5 * d2T)[None]
        d = jnp.sqrt(d2T + 1e-36)
        if self.nu == 1.5:
            return diffT * (3.0 * jnp.exp(-math.sqrt(3.0) * d))[None]
        if self.nu == 2.5:
            s = math.sqrt(5.0) * d
            return diffT * ((5.0 / 3.0) * (1.0 + s) * jnp.exp(-s))[None]
        k = jnp.exp(-d)
        return diffT * (k / jnp.maximum(d, 1e-12))[None]

    def dxdz_diag(self, x):
        ls = jnp.atleast_1d(self.lengthscale)
        if self.nu == math.inf:
            return jnp.ones_like(x) / (ls**2)
        if self.nu == 1.5:
            return 3.0 * jnp.ones_like(x) / (ls**2)
        if self.nu == 2.5:
            return (5.0 / 3.0) * jnp.ones_like(x) / (ls**2)
        raise NotImplementedError("dxdz_diag undefined for nu=0.5")

    def _collect_bounds(self, out):
        n = jnp.atleast_1d(self.lengthscale).size
        out.extend([self.bounds] * n)


@struct.dataclass
class Sum(Kernel):
    k1: Kernel
    k2: Kernel

    def __call__(self, X, Z=None):
        return self.k1(X, Z) + self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) + self.k2.diag(X)

    def pairwise(self, a, b):
        return self.k1.pairwise(a, b) + self.k2.pairwise(a, b)

    def dx(self, x, Z):
        return self.k1.dx(x, Z) + self.k2.dx(x, Z)

    def dxT(self, x, Z):
        return self.k1.dxT(x, Z) + self.k2.dxT(x, Z)

    def dxdz_diag(self, x):
        return self.k1.dxdz_diag(x) + self.k2.dxdz_diag(x)

    def _collect_bounds(self, out):
        self.k1._collect_bounds(out)
        self.k2._collect_bounds(out)


@struct.dataclass
class Product(Kernel):
    k1: Kernel
    k2: Kernel

    def __call__(self, X, Z=None):
        return self.k1(X, Z) * self.k2(X, Z)

    def diag(self, X):
        return self.k1.diag(X) * self.k2.diag(X)

    def pairwise(self, a, b):
        return self.k1.pairwise(a, b) * self.k2.pairwise(a, b)

    def dx(self, x, Z):
        a = self.k1(x, Z)[:, :, None]
        b = self.k2(x, Z)[:, :, None]
        return self.k1.dx(x, Z) * b + a * self.k2.dx(x, Z)

    def dxT(self, x, Z):
        # symmetric stationary kernels: k(x,Z)ᵀ = k(Z,x)
        aT = self.k1(Z, x)[None]
        bT = self.k2(Z, x)[None]
        return self.k1.dxT(x, Z) * bT + aT * self.k2.dxT(x, Z)

    def dxdz_diag(self, x):
        # d²(k1·k2)/da db = k1'' k2 + k1' k2' + ... ; for the common case of
        # Constant * stationary this reduces exactly.  General product of two
        # non-constant kernels falls back to autodiff.
        if isinstance(self.k1, (Constant, White)):
            c = self.k1.diag(x)[:, None]
            return c * self.k2.dxdz_diag(x)
        if isinstance(self.k2, (Constant, White)):
            c = self.k2.diag(x)[:, None]
            return c * self.k1.dxdz_diag(x)
        return Kernel.dxdz_diag(self, x)

    def _collect_bounds(self, out):
        self.k1._collect_bounds(out)
        self.k2._collect_bounds(out)
