"""Dataset loaders and synthetic generators.

* 2-D drawing npz (``example/2D/data/*.npz``: demo / floor / newfloor),
* 3-D example npz,
* ``reach_target`` multi-reference-frame dataset
  (``example/comparisons/multi_reference_frames/data/reach_target.npy``),
* frame → 10-point distribution expansion (``models/model_gpt.py:17-33``),
* random out-of-distribution frame generation
  (``generate_random_frame_orientation.py:4-36``),
* random GP-sampled 3-D surfaces (``example/3D/surface_generator.py``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

REFERENCE_ROOT = "/root/reference"


def load_2d_drawing(name: str = "example", root: Optional[str] = None) -> Dict[str, np.ndarray]:
    root = root or os.path.join(REFERENCE_ROOT, "example/2D/data")
    data = np.load(os.path.join(root, f"{name}.npz"))
    return {"demo": data["demo"], "floor": data["floor"], "newfloor": data["newfloor"]}


def load_3d_example(root: Optional[str] = None) -> Dict[str, np.ndarray]:
    root = root or os.path.join(REFERENCE_ROOT, "example/3D/data")
    data = np.load(os.path.join(root, "example.npz"))
    return {k: data[k] for k in data.files}


def load_reach_target(path: Optional[str] = None) -> Dict:
    """Returns dict with keys 'x' (list of (T,2) demos), 'A' (per-demo
    (T, n_frames, 2, 2) frame rotations), 'b' (frame origins)."""
    path = path or os.path.join(
        REFERENCE_ROOT, "example/comparisons/multi_reference_frames/data/reach_target.npy"
    )
    demos = np.load(path, allow_pickle=True, encoding="latin1")[()]
    return {"x": list(demos["x"]), "A": list(demos["A"]), "b": list(demos["b"])}


def make_reach_target(seed: int = 0, n_demos: int = 9, T: int = 100) -> Dict:
    """Seeded stand-in for the reach_target dataset, in the format of
    :func:`load_reach_target`: every demo runs from a random start frame to
    a random goal frame (two 2-D frames, fixed over time) along a smooth
    arc.  ``np.save(path, make_reach_target(), allow_pickle=True)`` writes a
    file ``load_reach_target(path)`` reads."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 1.0, T)[:, None]
    xs, As, bs = [], [], []
    for _ in range(n_demos):
        ang = rng.uniform(-np.pi, np.pi, 2)
        R = np.stack([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        R = np.transpose(R, (2, 0, 1))                       # (2 frames, 2, 2)
        b = rng.uniform(-20.0, 20.0, (2, 2))
        chord = b[1] - b[0]
        normal = np.array([-chord[1], chord[0]]) / np.linalg.norm(chord)
        bump = rng.uniform(-0.3, 0.3) * np.linalg.norm(chord)
        xs.append(b[0] + s * chord + np.sin(np.pi * s) * bump * normal)
        As.append(np.broadcast_to(R, (T, 2, 2, 2)).copy())
        bs.append(np.broadcast_to(b, (T, 2, 2)).copy())
    return {"x": xs, "A": As, "b": bs}


def distribution_from_frames(
    A: List, b: List, frame_dim: float = 5.0
) -> np.ndarray:
    """(n_demos, 10, 2) point-pair distributions from the start/goal frames
    of each demo (``model_gpt.py:17-33``): origin, ±frame_dim along each
    frame axis for both frames."""
    n = len(A)
    out = np.zeros((n, 10, 2))
    for i in range(n):
        A0, A1 = np.asarray(A[i][0][0]), np.asarray(A[i][0][1])
        b0, b1 = np.asarray(b[i][0][0]), np.asarray(b[i][0][1])
        out[i, 0] = b0
        out[i, 1] = b0 + A0 @ np.array([0.0, frame_dim])
        out[i, 2] = b1
        out[i, 3] = b1 + A1 @ np.array([0.0, -frame_dim])
        out[i, 4] = b0 + A0 @ np.array([0.0, -frame_dim])
        out[i, 5] = b1 + A1 @ np.array([0.0, frame_dim])
        out[i, 6] = b0 + A0 @ np.array([frame_dim, 0.0])
        out[i, 7] = b1 + A1 @ np.array([frame_dim, 0.0])
        out[i, 8] = b0 + A0 @ np.array([-frame_dim, 0.0])
        out[i, 9] = b1 + A1 @ np.array([-frame_dim, 0.0])
    return out


def generate_frame_orientation(
    A: List, b: List, rng: Optional[np.random.RandomState] = None,
    rotation_magnitude: float = 0.5, translation_offset: float = 20.0,
) -> Tuple[List, List]:
    """Randomly perturbed (rotated + translated) frames for the
    out-of-distribution generalization study."""
    import copy

    rng = rng or np.random.RandomState(0)
    A_new = copy.deepcopy(A)
    b_new = copy.deepcopy(b)
    for i in range(len(A)):
        for j in range(2):
            t = (translation_offset * rng.randn(2) - translation_offset / 2).reshape(-1)
            theta = rng.uniform(-rotation_magnitude * np.pi, rotation_magnitude * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s], [s, c]])
            A_new[i][0][j] = R @ np.asarray(A[i][0][j])
            b_new[i][0][j] = np.asarray(b_new[i][0][j]) + t
    return A_new, b_new


def random_gp_surface(
    key: jax.Array,
    n: int = 20,
    extent: float = 1.0,
    lengthscale: float = 0.4,
    amplitude: float = 0.2,
) -> jnp.ndarray:
    """(n, n, 3) random smooth surface: z ~ GP(0, RBF) sampled on a grid via
    Cholesky (``example/3D/surface_generator.py:24-33``).

    The grid Gram is numerically rank-deficient, so its Cholesky is taken
    on the host in float64 whatever JAX's default dtype."""
    g = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(g, g)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = (((pts[:, None, :] - pts[None, :, :]) / lengthscale) ** 2).sum(-1)
    K = amplitude**2 * np.exp(-0.5 * d2) + 1e-8 * np.eye(pts.shape[0])
    L = np.linalg.cholesky(K)
    z = L @ np.asarray(jax.random.normal(key, (pts.shape[0],)), np.float64)
    return jnp.asarray(np.stack([gx, gy, z.reshape(n, n)], axis=-1))


def spiral_demo(
    key: jax.Array,
    n_spiral: int = 360,
    n_lift: int = 100,
    n_grid: int = 20,
    lengthscale: float = 0.7,
    amplitude: float = 0.1,
):
    """Synthetic 3-D spiral demonstration over a flat source surface and a
    GP-sampled target surface (``example/3D/spiral.py``: turtle-drawn spiral
    + parabolic lift + Cholesky-sampled RBF surface).  The turtle plotter is
    replaced by a closed-form Archimedean spiral.  Returns
    ``(demo (N,3), old_surface (n,n,3), new_surface (n,n,3))``.
    """
    t = np.linspace(0.0, 6.0 * np.pi, n_spiral)
    r = 0.02 + 0.15 * t
    x = r * np.cos(t)
    y = r * np.sin(t)
    z = np.zeros_like(x)

    # Parabolic lift from the spiral's end back to its start
    # (``spiral.py`` calc_parabola_vertex through (0,0),(0.5,1),(1,0)).
    s = np.linspace(0.0, 1.0, n_lift)
    zl = 4.0 * s * (1.0 - s)
    xl = (1 - s) * x[-1] + s * x[0]
    yl = (1 - s) * y[-1] + s * y[0]
    demo = np.column_stack(
        [np.concatenate([x, xl]), np.concatenate([y, yl]), np.concatenate([z, zl])]
    )

    ext = float(np.abs(demo[:, :2]).max()) * 1.1
    g = np.linspace(-ext, ext, n_grid)
    gx, gy = np.meshgrid(g, g)
    old_surface = np.stack([gx, gy, np.zeros_like(gx)], axis=-1)
    new_surface = np.asarray(
        random_gp_surface(
            key, n=n_grid, extent=ext, lengthscale=lengthscale, amplitude=amplitude
        )
    )
    return demo, old_surface, new_surface


def complete_surface(
    points: np.ndarray,
    grid_n: int = 20,
    num_inducing: int = 1000,
    num_epochs: int = 5,
    seed: int = 0,
    margins: float = 0.0,
) -> np.ndarray:
    """SVGP surface completion: fit z(x, y) on a raw point cloud and
    evaluate on a grid over its xy bounding box → (grid_n², 3) distribution
    (offline half of ``sensors/surface_pointcloud_detector.py:85-157``)."""
    from ..models.svgp import StochasticVariationalGaussianProcess

    points = np.asarray(points)
    xy, z = points[:, :2], points[:, 2:3]
    model = StochasticVariationalGaussianProcess(
        xy, z, num_inducing=min(num_inducing, len(xy)), seed=seed
    )
    model.fit(num_epochs=num_epochs)
    gx = np.linspace(xy[:, 0].min() + margins, xy[:, 0].max() - margins, grid_n)
    gy = np.linspace(xy[:, 1].min() + margins, xy[:, 1].max() - margins, grid_n)
    GX, GY = np.meshgrid(gx, gy)
    grid = np.column_stack([GX.ravel(), GY.ravel()])
    zg = np.asarray(model.predict(grid))[:, 0]
    return np.column_stack([grid, zg])


def load_lasa(name: str = "Angle", root: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
    """LASA handwriting dataset loader (used by the reference's paper
    figures, ``example/paper_figures/load_data.py``).  Returns a list of
    demos, each ``{"pos": (T, 2), "t": (T,), "vel": (T, 2), "acc": (T, 2)}``
    (time-major, unlike the raw (2, T) .mat layout)."""
    from scipy.io import loadmat

    root = root or os.path.join(REFERENCE_ROOT, "example/paper_figures/DataSet")
    mat = loadmat(os.path.join(root, f"{name}.mat"))
    demos = []
    for demo in mat["demos"][0]:
        fields = {n: demo[n][0, 0] for n in ("pos", "t", "vel", "acc")}
        demos.append(
            {
                "pos": np.asarray(fields["pos"], float).T,
                "t": np.asarray(fields["t"], float).ravel(),
                "vel": np.asarray(fields["vel"], float).T,
                "acc": np.asarray(fields["acc"], float).T,
            }
        )
    return demos
