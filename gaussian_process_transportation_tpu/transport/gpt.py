"""Gaussian-process transportation façade + fully-jitted fast path.

``GaussianProcessTransportation`` reproduces the attribute-driven protocol of
``policy_transportation/transportation/gaussian_process_transportation.py:11-30``:
set ``.source_distribution``, ``.target_distribution``, ``.training_traj``,
optionally ``.training_delta`` / ``.training_ori``; then
``fit_transportation()`` and ``apply_transportation()`` (which updates the
attributes in place, storing ``.std`` and ``.var_vel_transported``).

``transport_apply`` is the pure functional pipeline — affine γ, GP posterior
mean/std, Jacobian mean/var, velocity/variance push-forward — as ONE jitted
function of pytrees.  This is what the benchmark and ``vmap``-ed ensemble
paths call: an ensemble of transports is a single batched computation on the
device instead of the reference's Python loops.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import kernels as K
from ..models import exact_gp as gp_core
from ..models.affine import AffineParams
from ..models import affine as affine_core
from ..models.gp_regressor import GaussianProcess
from ..ops import quaternion as quat
from ..ops.batched_linalg import spd_inverse
from .core import PolicyTransport

Array = jax.Array


def default_transport_kernel(d: int = 1) -> K.Kernel:
    """C(0.1)·RBF(0.1) + White(1e-4), the reference's default
    (``gaussian_process_transportation.py:12``)."""
    return K.Constant(0.1) * K.RBF(0.1 * jnp.ones(d)) + K.White(1e-4)


class GaussianProcessTransportation:
    def __init__(self, kernel_transport: Optional[K.Kernel] = None, **gp_kwargs):
        kernel = kernel_transport if kernel_transport is not None else default_transport_kernel()
        self.method = PolicyTransport(GaussianProcess(kernel=kernel, **gp_kwargs))

    def fit_transportation(self, do_scale: bool = False, do_rotation: bool = True):
        self.method.fit(
            self.source_distribution,
            self.target_distribution,
            do_scale=do_scale,
            do_rotation=do_rotation,
        )

    def apply_transportation(self):
        self.training_traj_old = jnp.asarray(self.training_traj)
        self.training_traj, self.std = self.method.transport(self.training_traj_old)
        if hasattr(self, "training_delta") and self.training_delta is not None:
            self.training_delta, self.var_vel_transported = self.method.transport_velocity(
                self.training_traj_old, self.training_delta
            )
        if hasattr(self, "training_ori") and self.training_ori is not None:
            self.training_ori = self.method.transport_orientation(
                self.training_traj_old, self.training_ori
            )

    def sample_transportation(self):
        return self.method.sample_transportation(self.training_traj_old)


# ---------------------------------------------------------------------------
# Pure functional pipeline (jit / vmap / shard_map ready)
# ---------------------------------------------------------------------------

class TransportResult(NamedTuple):
    traj: Array  # Φ(X)                      (N, D)
    std: Array  # epistemic std of Ψ∘γ       (N, D)
    delta: Array  # J_Φ · ΔX                 (N, D)
    delta_var: Array  # J_Ψvar (J_γ ΔX)²     (N, D)
    min_abs_det: Array  # diffeo diagnostic  ()
    ori: Optional[Array] = None  # q(J_Φ)·q_demo (N, 4), when ori passed (3-D)


def fit_pipeline(
    kernel: K.Kernel,
    source_distribution: Array,
    target_distribution: Array,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
):
    """Fit γ and condition the Ψ GP (fixed hyperparameters) — jittable.

    Returns (AffineParams, ExactGP).  Hyperparameter optimization composes
    on top via models.exact_gp.fit/fit_jit on the residual dataset.
    """
    aff = affine_core.fit(
        source_distribution, target_distribution, do_scale=do_scale, do_rotation=do_rotation
    )
    src_aligned = affine_core.predict(aff, source_distribution)
    delta = target_distribution - src_aligned
    # cache K⁻¹: the transport conditions on small point sets (20–2500) and
    # queries whole trajectories — variances become matmuls against K⁻¹
    # instead of per-query triangular solves
    gp = gp_core.condition(kernel, src_aligned, delta, jitter, cache_k_inv=True)
    return aff, gp


def _det_small(M: Array) -> Array:
    """det over the leading axes of (..., D, D) with closed forms for
    D ≤ 3 — elementwise, instead of a batched LU of tiny matrices."""
    d = M.shape[-1]
    if d == 1:
        return M[..., 0, 0]
    if d == 2:
        return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    if d == 3:
        return (
            M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
        )
    return jnp.linalg.det(M)


def transport_apply(
    aff: AffineParams,
    gp: gp_core.ExactGP,
    traj: Array,
    delta: Array,
    ori: Optional[Array] = None,
) -> TransportResult:
    """The full uncertainty-aware transport of one policy — one fused graph.

    Math parity: ``policy_transportation.py:26-59``; with ``ori`` (N, 4)
    scalar-first demo quaternions (3-D maps only) also the orientation
    transport of ``policy_transportation.py:61-78`` — closest rotation to
    J_Φ via the batched squaring Bar-Itzhack
    (``ops.quaternion.from_rotation_matrix_iter``; no per-point eigh
    custom call), composed with the demo quaternion.

    Layout: all large intermediates are query-last — (N, Q) / (D, N, Q) /
    (P, D, Q) — so the big axis Q (trajectory length) is the minor,
    contiguous one.
    """
    HI = jax.lax.Precision.HIGHEST
    kernel = gp.kernel
    pos = affine_core.predict(aff, traj)  # (Q, D) — small
    Jg = (aff.scale * aff.rotation).astype(pos.dtype)  # J_γ = s·R, (D, D)

    # --- posterior mean / std (q-last) ---
    kT = kernel(gp.X, pos)  # (N, Q); symmetric stationary: k(X,pos) = k(pos,X)ᵀ
    meanT = jnp.einsum("np,nq->pq", gp.alpha, kT, precision=HI)  # (P, Q)
    if gp.K_inv is not None:
        KiK = jnp.dot(gp.K_inv, kT, precision=HI)  # (N, Q)
        var = kernel.diag(pos) - jnp.sum(KiK * kT, axis=0)
    else:
        V = gp_core._solve_lower_any(gp, kT)  # (N, Q)
        var = kernel.diag(pos) - jnp.sum(V * V, axis=0)
    std_q = jnp.sqrt(jnp.maximum(var, 0.0)) - jnp.sqrt(
        gp_core.white_noise_level(kernel)
    )  # (Q,) epistemic-only convention (gaussian_process.py:49)
    traj_new = pos + meanT.T
    std = jnp.broadcast_to(std_q[:, None], traj_new.shape)

    # --- Jacobian posterior (q-last) ---
    dkT = kernel.dxT(pos, gp.X)  # (D, N, Q)
    JpsiT = jnp.einsum("np,dnq->pdq", gp.alpha, dkT, precision=HI)  # (P, D, Q)
    if gp.K_inv is not None:
        KidkT = jnp.einsum("nm,dmq->dnq", gp.K_inv, dkT, precision=HI)
        quadT = jnp.sum(KidkT * dkT, axis=1)  # (D, Q)
    elif gp.chol is not None:
        D_, N_, Q_ = dkT.shape
        rhs = jnp.transpose(dkT, (1, 0, 2)).reshape(N_, D_ * Q_)
        Vd = gp_core._solve_lower_any(gp, rhs)  # (N, D·Q)
        quadT = jnp.sum((Vd * Vd).reshape(N_, D_, Q_), axis=0)  # (D, Q)
    else:
        from ..ops.linalg import tri_solve_lower

        Vd = jax.vmap(lambda B: tri_solve_lower(gp.L, B))(dkT)  # (D, N, Q)
        quadT = jnp.sum(Vd * Vd, axis=1)
    JvarT = kernel.dxdz_diag(pos).T - quadT  # (D, Q)

    # J_Φ = J_γ + J_Ψ J_γ ; diffeo det diagnostic (policy_transportation.py:45-47)
    JphiT = Jg[:, :, None] + jnp.einsum("peq,ed->pdq", JpsiT, Jg, precision=HI)  # (P, D, Q)
    Jphi = jnp.moveaxis(JphiT, -1, 0)  # (Q, P, D) — small, for the det only
    min_abs_det = jnp.min(jnp.abs(_det_small(Jphi)))

    # velocity / variance push-forward (q-last)
    vT = delta.T  # (D, Q)
    wT = jnp.dot(Jg, vT, precision=HI)  # (D, Q) = (J_γ v)ᵀ
    delta_newT = wT + jnp.einsum("pdq,dq->pq", JpsiT, wT, precision=HI)
    dvar_q = jnp.einsum("dq,dq->q", JvarT, wT**2, precision=HI)  # same across P
    delta_var = jnp.broadcast_to(dvar_q[:, None], traj_new.shape)

    ori_new = None
    if ori is not None:
        if Jphi.shape[-1] != 3 or Jphi.shape[-2] != 3:
            raise ValueError(
                f"Orientation transport requires a 3-D map; J_Φ is "
                f"{Jphi.shape[-2:]} (reference prints a warning and skips: "
                f"policy_transportation.py:75-77)"
            )
        q_phi = quat.from_rotation_matrix_iter(Jphi)  # (Q, 4)
        ori_new = quat.multiply(q_phi, jnp.asarray(ori))

    return TransportResult(traj_new, std, delta_newT.T, delta_var, min_abs_det,
                           ori_new)


@partial(jax.jit, static_argnames=("do_scale", "do_rotation"))
def fit_and_transport(
    kernel: K.Kernel,
    source_distribution: Array,
    target_distribution: Array,
    traj: Array,
    delta: Array,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Array] = None,
) -> TransportResult:
    """End-to-end: γ fit + Ψ conditioning + apply, one compiled program.

    ``vmap`` over (target_distribution, ...) axes gives batched multi-target
    transport; sharding the batch axis over a mesh gives the pod-scale
    ensemble path (see ``parallel.ensemble``).
    """
    aff, gp = fit_pipeline(
        kernel,
        source_distribution,
        target_distribution,
        do_scale=do_scale,
        do_rotation=do_rotation,
        jitter=jitter,
    )
    return transport_apply(aff, gp, traj, delta, ori=ori)


@partial(jax.jit, static_argnames=("do_scale", "do_rotation"))
def fit_and_transport_batched(
    kernel: K.Kernel,
    source_distribution: Array,
    target_distributions: Array,
    traj: Array,
    delta: Array,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Array] = None,
) -> TransportResult:
    """One shared (source, traj, delta) transported onto a batch of targets
    (E, N, D) — the ensemble workload — as a single program.

    Equivalent to ``vmap(lambda t: fit_and_transport(kernel, S, t, X, dX))``
    for small N: the Kabsch fit uses the closed-form SO(2) optimum instead
    of E tiny SVDs, and the N×N Cholesky + inverse go through
    ``ops.batched_linalg.spd_inverse``.  The query-sized contractions keep
    the vmapped layout of ``transport_apply``.  Members with N > 64 run
    one after another under ``lax.scan``.
    """
    source_distribution = jnp.asarray(source_distribution)
    targets = jnp.asarray(target_distributions)
    n, d = source_distribution.shape
    if n > 64:
        # Medium/large-N members (the reference's 3D workload: 2,500-point
        # distributions, example/3D/surface_generalization_3D.py:50-51):
        # scan over members, each one dense Cholesky — never a vmap of
        # large factorizations.
        def step(_, tgt):
            return None, fit_and_transport(
                kernel, source_distribution, tgt, traj, delta,
                do_scale=do_scale, do_rotation=do_rotation, jitter=jitter,
                ori=ori,
            )

        _, res = jax.lax.scan(step, None, targets)
        return res

    aff_b = affine_core.fit_batched(
        source_distribution, targets, do_scale=do_scale, do_rotation=do_rotation
    )
    src_al = jax.vmap(lambda a: affine_core.predict(a, source_distribution))(aff_b)
    delta_b = targets - src_al  # (E, n, d)

    K_b = jax.vmap(kernel)(src_al)  # (E, n, n)
    eff = gp_core._eff_jitter(src_al.dtype, jitter)
    K_b = K_b + eff * jnp.eye(n, dtype=src_al.dtype)
    L_b, Kinv_b = spd_inverse(K_b)
    alpha_b = jnp.einsum(
        "enm,emp->enp", Kinv_b, delta_b, precision=jax.lax.Precision.HIGHEST
    )

    def apply_one(aff, X, Y, L, alpha, K_inv):
        gp = gp_core.ExactGP(
            kernel=kernel, X=X, Y=Y, L=L, alpha=alpha, K_inv=K_inv, jitter=jitter
        )
        return transport_apply(aff, gp, traj, delta, ori=ori)

    return jax.vmap(apply_one)(aff_b, src_al, delta_b, L_b, alpha_b, Kinv_b)


@partial(jax.jit, static_argnames=("do_scale", "do_rotation", "n_restarts",
                                   "maxiter"))
def fit_and_transport_batched_opt(
    kernel: K.Kernel,
    source_distribution: Array,
    target_distributions: Array,
    traj: Array,
    delta: Array,
    n_restarts: int = 6,
    maxiter: int = 30,
    key: Optional[Array] = None,
    do_scale: bool = False,
    do_rotation: bool = True,
    jitter: float = 1e-10,
    ori: Optional[Array] = None,
) -> TransportResult:
    """Batched multi-target transport with PER-MEMBER hyperparameter
    optimization — the reference's actual default behavior (sklearn GPR
    re-fits hyperparameters per transport, ``models/gaussian_process.py:
    17-29`` under ``gaussian_process_transportation.py::fit_transportation``)
    at ensemble scale as ONE compiled program.

    Each member's Ψ-GP residual dataset (src_aligned_e, Δ_e) gets its own
    multi-restart L-BFGS fit through the fused multi-data LML
    (``models.exact_gp.fit_ensemble_fused``), then the
    transport runs with the fitted per-member kernels through the same
    ensemble-last conditioning as :func:`fit_and_transport_batched`.

    Requires the C·stationary(+White) family at n ≤ 32 members.
    """
    source_distribution = jnp.asarray(source_distribution)
    targets = jnp.asarray(target_distributions)
    n, d = source_distribution.shape
    if n > 32:
        raise ValueError(
            "fit_and_transport_batched_opt needs n <= 32 distribution points"
            " (the fused small-LML fit); use per-member fit_blocked beyond."
        )
    if key is None:
        key = jax.random.PRNGKey(0)

    aff_b = affine_core.fit_batched(
        source_distribution, targets, do_scale=do_scale, do_rotation=do_rotation
    )
    src_al = jax.vmap(lambda a: affine_core.predict(a, source_distribution))(aff_b)
    delta_b = targets - src_al  # (E, n, d)

    thetas, _ = gp_core.fit_ensemble_fused(
        kernel, src_al, delta_b, n_restarts=n_restarts, maxiter=maxiter,
        key=key, jitter=jitter,
    )
    kernels_b = jax.vmap(kernel.with_theta)(thetas)

    K_b = jax.vmap(lambda kn, x: kn(x))(kernels_b, src_al)  # (E, n, n)
    eff = gp_core._eff_jitter(src_al.dtype, jitter)
    K_b = K_b + eff * jnp.eye(n, dtype=src_al.dtype)
    L_b, Kinv_b = spd_inverse(K_b)
    alpha_b = jnp.einsum(
        "enm,emp->enp", Kinv_b, delta_b, precision=jax.lax.Precision.HIGHEST
    )

    def apply_one(kn, aff, X, Y, L, alpha, K_inv):
        gp = gp_core.ExactGP(
            kernel=kn, X=X, Y=Y, L=L, alpha=alpha, K_inv=K_inv, jitter=jitter
        )
        return transport_apply(aff, gp, traj, delta, ori=ori)

    return jax.vmap(apply_one)(
        kernels_b, aff_b, src_al, delta_b, L_b, alpha_b, Kinv_b
    )
