"""3-D surface-to-surface transport on the reference's real data
(example/3D/surface_generalization_3D.py workload, subsampled for CI)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import requires_reference, REFERENCE_ROOT

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.transport.gpt import fit_and_transport
import gaussian_process_transportation_tpu as gpt


@requires_reference
def test_3d_surface_transport():
    import os

    data = np.load(os.path.join(REFERENCE_ROOT, "example/3D/data/example.npz"))
    X = jnp.asarray(data["demo"])
    S = data["old_surface"].reshape(-1, 3)
    S1 = data["new_surface"].reshape(-1, 3)
    idx = np.random.RandomState(0).choice(len(S), 500, replace=False)
    S, S1 = jnp.asarray(S[idx]), jnp.asarray(S1[idx])
    dX = jnp.zeros_like(X).at[:-1].set(jnp.diff(X, axis=0))

    kern = K.Constant(0.1) * K.RBF(jnp.asarray([1.0])) + K.White(1e-4)
    res = fit_and_transport(kern, S, S1, X, dX)
    assert res.traj.shape == X.shape
    assert bool(jnp.isfinite(res.traj).all())
    assert bool(jnp.isfinite(res.delta).all())
    assert float(res.min_abs_det) > 0  # locally diffeomorphic

    # surface points land on the target surface
    res_s = fit_and_transport(kern, S, S1, S, jnp.zeros_like(S))
    err = float(jnp.abs(res_s.traj - S1).max())
    assert err < 0.15, err

    # the demo hovers above the surface; transported demo must move with it
    moved = float(jnp.abs(res.traj - X).mean())
    assert 0.2 < moved < 2.0, moved


@requires_reference
def test_3d_orientation_transport():
    import os

    data = np.load(os.path.join(REFERENCE_ROOT, "example/3D/data/example.npz"))
    X = np.asarray(data["demo"])[::5]
    S = data["old_surface"].reshape(-1, 3)[::10]
    S1 = data["new_surface"].reshape(-1, 3)[::10]

    tr = gpt.GaussianProcessTransportation(
        kernel_transport=K.Constant(0.1) * K.RBF(jnp.asarray([1.0])) + K.White(1e-4),
        optimizer=None,
    )
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj = X
    tr.training_ori = np.tile([1.0, 0, 0, 0], (len(X), 1))
    tr.fit_transportation()
    tr.apply_transportation()
    q = np.asarray(tr.training_ori)
    assert q.shape == (len(X), 4)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-8)


def test_spiral_demo_generator():
    """Synthetic spiral workload (example/3D/spiral.py): demo is a planar
    spiral closed by a parabolic lift; surfaces are grid-aligned with the
    target sampled from a smooth GP."""
    from gaussian_process_transportation_tpu.data.datasets import spiral_demo

    demo, old_s, new_s = spiral_demo(jax.random.PRNGKey(0), n_grid=12)
    assert demo.shape[1] == 3 and old_s.shape == (12, 12, 3)
    # spiral section is planar; lift peaks at z=1 (parabola vertex)
    assert abs(demo[:360, 2]).max() == 0.0
    np.testing.assert_allclose(demo[:, 2].max(), 1.0, atol=1e-2)
    # lift connects spiral end back to its start
    np.testing.assert_allclose(demo[-1, :2], demo[0, :2], atol=1e-9)
    # surfaces share the xy grid; GP target is smooth but non-flat
    np.testing.assert_allclose(old_s[..., :2], new_s[..., :2], atol=1e-6)
    assert 1e-3 < np.abs(new_s[..., 2]).max() < 3.0


@requires_reference
def test_batched_orientation_transport_parity():
    """Orientation transport in the batched jitted path:

    * ``fit_and_transport(..., ori=...)`` must match the stateful wrapper's
      ``transport_orientation`` (parity route to the reference's
      policy_transportation.py:61-78) — same J_Φ pipeline, squaring vs
      eigh Bar-Itzhack;
    * each member of ``fit_and_transport_batched(..., ori=...)`` at
      ensemble scale must equal the corresponding single transport.
    """
    import os
    from gaussian_process_transportation_tpu.transport.gpt import (
        fit_and_transport_batched,
    )

    data = np.load(os.path.join(REFERENCE_ROOT, "example/3D/data/example.npz"))
    X = jnp.asarray(np.asarray(data["demo"])[::5])
    # n≈26 keeps the E-last unrolled conditioning's CPU compile cheap (the
    # batched small-n branch; larger n routes to scan on this path anyway)
    S = data["old_surface"].reshape(-1, 3)[::96]
    S1 = data["new_surface"].reshape(-1, 3)[::96]
    S, S1 = jnp.asarray(S), jnp.asarray(S1)
    dX = jnp.zeros_like(X).at[:-1].set(jnp.diff(X, axis=0))
    rs = np.random.RandomState(2)
    q_demo = rs.randn(len(X), 4)
    q_demo = jnp.asarray(q_demo / np.linalg.norm(q_demo, axis=1, keepdims=True))

    kern = K.Constant(0.1) * K.RBF(jnp.asarray([1.0])) + K.White(1e-4)

    res = fit_and_transport(kern, S, S1, X, dX, ori=q_demo)
    assert res.ori is not None and res.ori.shape == (len(X), 4)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(res.ori), axis=1), 1.0, atol=1e-8
    )

    # stateful wrapper route (eigh Bar-Itzhack) — same math
    tr = gpt.GaussianProcessTransportation(kernel_transport=kern, optimizer=None)
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj, tr.training_ori = X, q_demo
    tr.fit_transportation()
    tr.apply_transportation()
    q_wrap = np.asarray(tr.training_ori)
    q_fast = np.asarray(res.ori)
    err = np.minimum(
        np.abs(q_fast - q_wrap).max(-1), np.abs(q_fast + q_wrap).max(-1)
    )
    assert err.max() < 1e-5, err.max()

    # ensemble: E shifted targets, member-wise equality with singles
    E = 8
    shifts = jnp.linspace(0.0, 0.3, E)[:, None, None]
    targets = S1[None] + shifts
    batched = fit_and_transport_batched(kern, S, targets, X, dX, ori=q_demo)
    assert batched.ori.shape == (E, len(X), 4)
    for e in [0, 3, 7]:
        single = fit_and_transport(kern, S, targets[e], X, dX, ori=q_demo)
        np.testing.assert_allclose(
            np.asarray(batched.ori[e]), np.asarray(single.ori), atol=1e-6
        )
