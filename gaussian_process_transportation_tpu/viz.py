"""Vector fields, rollouts, and plotting helpers.

Compute parts (grid fields, Euler rollouts) are pure jitted functions —
the reference's per-cell Python loops (``plot_utils.py:181-207``, the 10⁴
GP predicts per figure) become one batched predict + one ``lax.scan``.
Matplotlib is imported lazily so headless environments never pay for
it; every ``plot_*``/``draw_*`` helper degrades to a no-op if matplotlib
is unavailable.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models import exact_gp as core

Array = jax.Array


# ---------------------------------------------------------------------------
# Compute
# ---------------------------------------------------------------------------

def vector_field(
    gp: core.ExactGP, x_grid: Array, y_grid: Array
) -> Tuple[Array, Array, Array]:
    """(u, v, std) on the meshgrid — the reference's ``create_vectorfield``
    as one batched predict."""
    gx, gy = jnp.meshgrid(jnp.asarray(x_grid), jnp.asarray(y_grid))
    pos = jnp.column_stack([gx.ravel(), gy.ravel()])
    mean, std = core.predict(gp, pos, return_std=True)
    shape = gx.shape
    return (
        mean[:, 0].reshape(shape),
        mean[:, 1].reshape(shape),
        std.reshape(shape + (std.shape[1],)),
    )


def rollout_gp_ds(
    gp: core.ExactGP,
    x0: Array,
    n_steps: int,
    dt: float = 1.0,
    modulation_fn: Optional[Callable[[Array], Array]] = None,
) -> Array:
    """Euler rollout of the GP dynamical system ẋ = f(x) (optionally
    modulated: ẋ = M(x) f(x)); x0: (B, D) → (n_steps, B, D)."""

    def step(x, _):
        v = core.predict(gp, x)
        if modulation_fn is not None:
            v = (modulation_fn(x) @ v[:, :, None])[:, :, 0]
        x_new = x + v * dt
        return x_new, x_new

    _, traj = jax.lax.scan(step, jnp.asarray(x0), None, length=n_steps)
    return traj


def rollout_stable_gp_ds(
    gp: core.ExactGP, x0: Array, n_steps: int = 1000
) -> Array:
    """Uncertainty-stabilized Euler rollout of the GP dynamical system —
    the compute core of the reference's ``plot_traj_evolution``
    (``plot_utils.py:298-310``): per step,
    ``pos += vel − std · ∂σ²/∂x / ‖∂σ²/∂x‖`` (the predictive-std-scaled
    descent of the variance keeps the rollout near the demonstration).
    The reference runs 1000 sequential ``model.predict`` Python calls per
    trajectory; here it is one ``lax.scan`` over a batch: x0 (B, D) →
    (n_steps, B, D)."""

    def step(x, _):
        vel, std = core.predict(gp, x, return_std=True)
        g = core.variance_gradient(gp, x)
        n = jnp.linalg.norm(g, axis=1, keepdims=True)
        f_stable = g / jnp.maximum(n, 1e-12)
        x_new = x + vel - std * f_stable
        return x_new, x_new

    _, traj = jax.lax.scan(step, jnp.asarray(x0), None, length=n_steps)
    return traj


def plot_traj_evolution(
    gp, x_grid, y_grid, z_grid, demo=None, surface=None, n_steps=1000, key=None
):
    """3D trajectory-evolution figure (``plot_utils.py:298-318``): roll a
    stabilized GP-DS trajectory from a uniform-random start in the grid box
    and plot it over the surface + demonstration.  Returns the 3D axis."""
    plt = _plt()
    if plt is None:
        return None
    if key is None:
        key = jax.random.PRNGKey(0)
    lo = jnp.asarray([x_grid[0], y_grid[0], z_grid[0]], jnp.float32)
    hi = jnp.asarray([x_grid[-1], y_grid[-1], z_grid[-1]], jnp.float32)
    x0 = jax.random.uniform(key, (1, 3), minval=lo, maxval=hi)
    traj = np.asarray(rollout_stable_gp_ds(gp, x0, n_steps))[:, 0]
    ax = plot_traj_3D(traj, surface)
    if ax is not None and demo is not None:
        demo = np.asarray(demo)
        ax.scatter(demo[:, 0], demo[:, 1], demo[:, 2], color=[1, 0, 0])
    return ax


def plot_traj_3D(trajectory, surface=None, ax=None):
    """Trajectory scatter over a (Gx, Gy, 3) surface mesh
    (``plot_utils.py:320-325``)."""
    plt = _plt()
    if plt is None:
        return None
    if ax is None:
        ax = plt.figure().add_subplot(projection="3d")
    if surface is not None:
        from matplotlib import cm

        surface = np.asarray(surface)
        ax.plot_surface(
            surface[:, :, 0], surface[:, :, 1], surface[:, :, 2],
            cmap=cm.coolwarm, linewidth=0, antialiased=False,
        )
    trajectory = np.asarray(trajectory)
    ax.scatter(
        trajectory[:, 0], trajectory[:, 1], trajectory[:, 2], color=[0, 0, 1]
    )
    return ax


def min_variance_attractor_field(
    gp: core.ExactGP, query: Array, step: float = 1.0
) -> Array:
    """Velocity field that descends the predictive variance — the
    uncertainty-seeking attractor field of ``plot_utils.py:283-297``:
    v(x) = −∂σ²/∂x, normalized."""
    g = core.variance_gradient(gp, jnp.asarray(query))
    n = jnp.linalg.norm(g, axis=1, keepdims=True)
    return -step * g / jnp.maximum(n, 1e-12)


# ---------------------------------------------------------------------------
# Plotting (lazy matplotlib)
# ---------------------------------------------------------------------------

def _plt():
    try:
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_vector_field(gp, x_grid, y_grid, demo=None, surface=None, ax=None, density=2):
    plt = _plt()
    if plt is None:
        return None
    u, v, _ = vector_field(gp, x_grid, y_grid)
    gx, gy = np.meshgrid(np.asarray(x_grid), np.asarray(y_grid))
    ax = ax or plt.figure(figsize=(12, 7)).gca()
    ax.streamplot(gx, gy, np.asarray(u), np.asarray(v), density=density)
    if demo is not None:
        ax.scatter(np.asarray(demo)[:, 0], np.asarray(demo)[:, 1], color=[1, 0, 0])
    if surface is not None:
        ax.scatter(np.asarray(surface)[:, 0], np.asarray(surface)[:, 1], color=[0, 0, 0])
    return ax


def draw_error_band(ax, x, y, err, loop: bool = False, **kwargs):
    """Normal-offset error band around a curve (``plot_utils.py:326-352``)."""
    plt = _plt()
    if plt is None or ax is None:
        return None
    from matplotlib.patches import PathPatch
    from matplotlib.path import Path

    x, y = np.asarray(x), np.asarray(y)
    err = np.asarray(err)
    if err.ndim == 2:
        err = np.linalg.norm(err, axis=1)
    dx = np.gradient(x)
    dy = np.gradient(y)
    l = np.hypot(dx, dy)
    l = np.where(l > 1e-12, l, 1.0)
    nx, ny = dy / l, -dx / l
    xp, yp = x + nx * err, y + ny * err
    xn, yn = x - nx * err, y - ny * err
    vertices = np.block([[xp, xn[::-1]], [yp, yn[::-1]]]).T
    codes = np.full(len(vertices), Path.LINETO)
    codes[0] = codes[len(xp)] = Path.MOVETO
    path = Path(vertices, codes)
    ax.add_patch(PathPatch(path, **kwargs))
    return ax
