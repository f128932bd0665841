"""Pod-scale transport ensembles.

The reference transports one policy at a time in Python (its ensembles are
Python loops over sklearn/torch models, e.g.
``models/torch/ensemble_neural_network.py:9-15``).  Here an ensemble of E
transport problems — different target distributions, hyperparameters, or
posterior draws — is ONE batched XLA program ``vmap``-ed over the member
axis and sharded over the ``ens`` mesh axis, so members run data-parallel
across chips with zero communication until the final gather.

``ensemble_train_step`` additionally takes a joint Adam step on kernel
log-hyperparameters against the summed LML — the gradient reduction over
the mesh is XLA-inserted (psum over 'ens') from the sharding alone.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import Kernel
from ..models import exact_gp as gp_core
from ..models import affine as affine_core
from ..transport import gpt as gpt_mod
from .mesh import ensemble_sharding, global_put

Array = jax.Array


def transport_ensemble(
    kernel: Kernel,
    source: Array,  # (M, D)
    targets: Array,  # (E, M, D) — one target distribution per member
    traj: Array,  # (N, D)
    delta: Array,  # (N, D)
    mesh: Optional[Mesh] = None,
    ori: Optional[Array] = None,  # (N, 4) demo quaternions (3-D maps)
) -> gpt_mod.TransportResult:
    """Fit+apply E independent transports as one sharded computation."""
    f = lambda tgts: gpt_mod.fit_and_transport_batched(
        kernel, source, tgts, traj, delta, ori=ori
    )
    if mesh is not None:
        targets = global_put(targets, ensemble_sharding(mesh))
        result_tree = gpt_mod.TransportResult(
            0, 0, 0, 0, 0, None if ori is None else 0
        )
        out_sharding = jax.tree_util.tree_map(
            lambda _: ensemble_sharding(mesh), result_tree
        )
        f = jax.jit(f, out_shardings=out_sharding)
    else:
        f = jax.jit(f)
    return f(targets)


def posterior_transport_ensemble(
    kernel: Kernel,
    source: Array,
    target: Array,
    traj: Array,
    key: Array,
    n_members: int,
    mesh: Optional[Mesh] = None,
) -> Array:
    """E posterior draws of the transported trajectory (SMC particle set).

    Each member transports the trajectory through an independent posterior
    sample of the delta map — the batched version of the reference's
    ``sample_transportation`` (10 samples in a Python loop) scaled to ≥10k
    members sharded over the mesh.
    """
    aff, gp = gpt_mod.fit_pipeline(kernel, source, target)
    pos_aligned = affine_core.predict(aff, traj)
    keys = jax.random.split(key, n_members)
    if mesh is not None:
        keys = global_put(keys, ensemble_sharding(mesh))

    mean, cov = gp_core.predict_cov(gp, pos_aligned)
    L = jnp.linalg.cholesky(gp_core.add_diagonal(cov, 1e-8))

    @jax.jit
    def draw(k):
        eps = jax.random.normal(k, mean.shape, mean.dtype)
        return pos_aligned + mean + L @ eps

    return jax.jit(jax.vmap(draw))(keys)


def make_ensemble_train_step(kernel: Kernel, optimizer=None):
    """Joint hyperparameter training step over a sharded ensemble.

    Returns ``step(theta, opt_state, sources, targets) -> (theta, opt_state,
    loss)`` where the loss is the mean negative LML of every member's
    residual dataset; members shard over 'ens' and the gradient psum is
    inserted by XLA.
    """
    optimizer = optimizer or optax.adam(1e-2)

    def member_nll(theta, source, target):
        aff = affine_core.fit(source, target)
        src_aligned = affine_core.predict(aff, source)
        delta = target - src_aligned
        k = kernel.with_theta(theta)
        return -gp_core.log_marginal_likelihood(k, src_aligned, delta)

    def loss_fn(theta, sources, targets):
        nlls = jax.vmap(member_nll, in_axes=(None, 0, 0))(theta, sources, targets)
        return jnp.mean(nlls)

    @jax.jit
    def step(theta, opt_state, sources, targets):
        loss, g = jax.value_and_grad(loss_fn)(theta, sources, targets)
        updates, opt_state = optimizer.update(g, opt_state, theta)
        theta = optax.apply_updates(theta, updates)
        return theta, opt_state, loss

    return step, optimizer
