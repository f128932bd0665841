"""SMC-style particle ensembles of transported policies.

BASELINE.json north star: "ensembles of transported policies shard as
SMC-style particles with collective resampling".  A particle is one
posterior draw of the transported policy (trajectory + velocity field
sample); weights come from any task-space likelihood (e.g. goal reaching,
obstacle clearance, demonstrated-shape agreement); systematic resampling
runs ON DEVICE and, under a mesh, as a collective: weights are normalized
with a global ``psum``-style reduction (XLA inserts it from the sharding)
and the gather of surviving particles is a collective.

All functions are pure and jittable; the particle axis shards over 'ens'.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import Kernel
from ..models import exact_gp as gp_core
from ..models import affine as affine_core
from ..transport import gpt as gpt_mod
from .mesh import ensemble_sharding

Array = jax.Array


class ParticleEnsemble(NamedTuple):
    trajectories: Array  # (E, N, D) transported trajectory per particle
    log_weights: Array  # (E,)


def init_particles(
    kernel: Kernel,
    source: Array,
    target: Array,
    traj: Array,
    key: Array,
    n_particles: int,
    mesh: Optional[Mesh] = None,
) -> ParticleEnsemble:
    """E posterior draws of the transported trajectory, uniform weights."""
    aff, gp = gpt_mod.fit_pipeline(kernel, source, target)
    pos_aligned = affine_core.predict(aff, traj)
    mean, cov = gp_core.predict_cov(gp, pos_aligned)
    L = jnp.linalg.cholesky(gp_core.add_diagonal(cov, 1e-8))
    keys = jax.random.split(key, n_particles)
    if mesh is not None:
        from .mesh import global_put
        keys = global_put(keys, ensemble_sharding(mesh))

    @jax.jit
    def draw(k):
        eps = jax.random.normal(k, mean.shape, mean.dtype)
        return pos_aligned + mean + L @ eps

    trajs = jax.jit(jax.vmap(draw))(keys)
    return ParticleEnsemble(
        trajectories=trajs,
        log_weights=jnp.zeros(n_particles) - jnp.log(n_particles),
    )


@jax.jit
def reweight(
    particles: ParticleEnsemble, log_likelihoods: Array
) -> ParticleEnsemble:
    """Multiply weights by per-particle likelihoods and renormalize
    (log-space; the logsumexp is the cross-device reduction)."""
    lw = particles.log_weights + log_likelihoods
    lw = lw - jax.scipy.special.logsumexp(lw)
    return particles._replace(log_weights=lw)


@jax.jit
def effective_sample_size(particles: ParticleEnsemble) -> Array:
    w = jnp.exp(particles.log_weights)
    return 1.0 / jnp.sum(w**2)


@jax.jit
def systematic_resample(particles: ParticleEnsemble, key: Array) -> ParticleEnsemble:
    """Systematic (low-variance) resampling: one uniform offset, E strata.

    The cumulative-weight scan and the gather are single collectives over
    the sharded particle axis."""
    E = particles.log_weights.shape[0]
    w = jnp.exp(particles.log_weights)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key) / E
    points = u0 + jnp.arange(E) / E
    # prefix-count instead of jnp.searchsorted: idx_j = #{i : cum_i < p_j}.
    # The (E, E) broadcast-compare + row-reduce is one fused elementwise
    # pass and trivial HLO — searchsorted's scan lowering compiles far
    # slower for the same result.
    idx = jnp.sum((cum[None, :] < points[:, None]).astype(jnp.int32), axis=1)
    idx = jnp.clip(idx, 0, E - 1)
    return ParticleEnsemble(
        trajectories=particles.trajectories[idx],
        log_weights=jnp.zeros(E) - jnp.log(E),
    )


def smc_step(
    particles: ParticleEnsemble,
    log_likelihood_fn: Callable[[Array], Array],
    key: Array,
    ess_threshold: float = 0.5,
) -> Tuple[ParticleEnsemble, Array]:
    """One reweight(+conditional resample) step.

    log_likelihood_fn maps (E, N, D) trajectories → (E,) log-likelihoods.
    Resampling triggers when ESS < ess_threshold · E."""
    ll = log_likelihood_fn(particles.trajectories)
    particles = reweight(particles, ll)
    ess = effective_sample_size(particles)
    E = particles.log_weights.shape[0]

    def do_resample(p):
        return systematic_resample(p, key)

    particles = jax.lax.cond(
        ess < ess_threshold * E, do_resample, lambda p: p, particles
    )
    return particles, ess


# ---------------------------------------------------------------------------
# Common task likelihoods
# ---------------------------------------------------------------------------

def goal_likelihood(goal: Array, scale: float = 1.0) -> Callable[[Array], Array]:
    """log p ∝ −‖x_T − goal‖²/(2 scale²)."""

    def ll(trajs):
        d = jnp.linalg.norm(trajs[:, -1, :] - goal, axis=1)
        return -0.5 * (d / scale) ** 2

    return ll


def clearance_likelihood(gamma_fn: Callable[[Array], Array], margin: float = 1.0,
                         sharpness: float = 5.0) -> Callable[[Array], Array]:
    """Penalize particles whose trajectories enter Γ < margin regions.

    gamma_fn: (N, D) → (K, N) obstacle Γ values (see avoidance.gamma)."""

    def ll(trajs):
        def one(traj):
            g = gamma_fn(traj)
            violation = jnp.sum(jax.nn.relu(margin - jnp.min(g, axis=0)))
            return -sharpness * violation

        return jax.vmap(one)(trajs)

    return ll
