"""Sharded-vs-unsharded numerical equality on the 8-device mesh
(sharding must be value-preserving, not just
shape-preserving)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.parallel import (
    make_mesh,
    make_ensemble_train_step,
    transport_ensemble,
)
from gaussian_process_transportation_tpu.transport import gpt as gpt_mod


def _problem(E=16, n_traj=60, n_dist=20):
    t = np.linspace(0, 1, n_traj)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, n_dist)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + np.sin(2 * s)], 1)
    shifts = np.linspace(0.0, 1.0, E)
    targets = S1[None] + shifts[:, None, None]
    return map(jnp.asarray, (X, dX, S, targets))


@pytest.mark.slow
def test_transport_ensemble_sharded_equals_vmap():
    X, dX, S, targets = _problem()
    kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.01)
    mesh = make_mesh(n_ens=4, n_data=2)

    sharded = transport_ensemble(kernel, S, targets, X, dX, mesh=mesh)
    ref = jax.jit(
        lambda tg: gpt_mod.fit_and_transport_batched(kernel, S, tg, X, dX)
    )(targets)

    for field in ("traj", "delta", "std", "delta_var"):
        a = np.asarray(getattr(sharded, field))
        b = np.asarray(getattr(ref, field))
        # f64 end to end: any layout/collective bug shows up far above this
        assert np.allclose(a, b, rtol=1e-12, atol=1e-12), (
            field, np.abs(a - b).max())


@pytest.mark.slow
def test_ensemble_train_step_sharded_equals_unsharded():
    X, dX, S, targets = _problem()
    E = targets.shape[0]
    kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.01)
    mesh = make_mesh(n_ens=8, n_data=1)
    sources = jnp.broadcast_to(S, (E,) + S.shape)

    step, opt = make_ensemble_train_step(kernel)

    theta_a = kernel.theta
    st_a = opt.init(theta_a)
    for _ in range(3):
        theta_a, st_a, loss_a = step(theta_a, st_a, sources, targets)

    from jax.sharding import NamedSharding, PartitionSpec as P

    src_sh = jax.device_put(sources, NamedSharding(mesh, P("ens")))
    tgt_sh = jax.device_put(targets, NamedSharding(mesh, P("ens")))
    theta_b = kernel.theta
    st_b = opt.init(theta_b)
    for _ in range(3):
        theta_b, st_b, loss_b = step(theta_b, st_b, src_sh, tgt_sh)

    # the loss mean reduces over the mesh (psum order differs) — f64 keeps
    # that reordering noise at the last few ulps
    assert np.allclose(np.asarray(theta_b), np.asarray(theta_a), atol=1e-12)
    assert np.isclose(float(loss_b), float(loss_a), atol=1e-12)
