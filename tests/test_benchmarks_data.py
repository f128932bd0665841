"""Data adapters + benchmark harnesses (multi-reference-frames, surfaces
comparison, tags, surface completion)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import requires_reference

from gaussian_process_transportation_tpu.data import datasets, tags
from gaussian_process_transportation_tpu.benchmarks import (
    MultipleReferenceFramesGPT,
    ablation_study,
    run_comparison,
    mann_whitney_ranking,
)

rng = np.random.RandomState(8)


# ---------------------------------------------------------------------------
# Tag adapters
# ---------------------------------------------------------------------------

def _tag(id_, pos, ori=(1.0, 0, 0, 0), size=0.1):
    return {"id": id_, "position": np.asarray(pos, float), "orientation": np.asarray(ori, float), "size": size}


def test_convert_distribution_matches_ids():
    source = [_tag(1, [0, 0, 0]), _tag(2, [1, 0, 0]), _tag(9, [5, 5, 5])]
    target = [_tag(2, [1, 1, 0]), _tag(1, [0, 1, 0]), _tag(7, [9, 9, 9])]
    s, t, d = tags.convert_distribution(source, target)
    assert s.shape == (2, 3) and t.shape == (2, 3)  # tags 1 and 2 only
    np.testing.assert_allclose(t - s, np.tile([0, 1, 0], (2, 1)))
    np.testing.assert_allclose(d, 2.0)


def test_convert_distribution_with_corners():
    source = [_tag(1, [0, 0, 0])]
    target = [_tag(1, [0, 1, 0])]
    s, t, d = tags.convert_distribution(source, target, use_orientation=True)
    assert s.shape == (13, 3)  # center + 12 cube corners
    np.testing.assert_allclose(t - s, np.tile([0, 1, 0], (13, 1)), atol=1e-12)


def test_find_closest_source():
    target = [_tag(1, [0, 0, 0])]
    far = [_tag(1, [5, 0, 0])]
    near = [_tag(1, [0.1, 0, 0])]
    s, t, idx = tags.find_closest_source_to_target([far, near], target)
    assert idx == 1


def test_rotated_corners():
    # 90° about z: corner (x,y,z) → (−y,x,z)
    q = np.array([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)])
    source = [_tag(1, [0, 0, 0], ori=(1, 0, 0, 0))]
    target = [_tag(1, [0, 0, 0], ori=q)]
    s, t, _ = tags.convert_distribution(source, target, use_orientation=True)
    c_s, c_t = s[1:], t[1:]
    expected = np.stack([-c_s[:, 1], c_s[:, 0], c_s[:, 2]], axis=1)
    np.testing.assert_allclose(c_t, expected, atol=1e-9)


# ---------------------------------------------------------------------------
# Synthetic surface generation / completion
# ---------------------------------------------------------------------------

def test_random_gp_surface():
    surf = datasets.random_gp_surface(jax.random.PRNGKey(0), n=12)
    assert surf.shape == (12, 12, 3)
    z = np.asarray(surf[..., 2])
    assert np.isfinite(z).all() and z.std() > 1e-4


def test_complete_surface():
    pts = rng.uniform(-1, 1, (800, 2))
    z = 0.2 * np.sin(2 * pts[:, 0]) + 0.1 * pts[:, 1]
    cloud = np.column_stack([pts, z + 0.01 * rng.randn(800)])
    dist = datasets.complete_surface(cloud, grid_n=10, num_inducing=80, num_epochs=30)
    assert dist.shape == (100, 3)
    z_true = 0.2 * np.sin(2 * dist[:, 0]) + 0.1 * dist[:, 1]
    assert np.sqrt(np.mean((dist[:, 2] - z_true) ** 2)) < 0.05


# ---------------------------------------------------------------------------
# Multi-reference-frames benchmark
# ---------------------------------------------------------------------------

@requires_reference
def test_reach_target_loader_and_distribution():
    d = datasets.load_reach_target()
    assert len(d["x"]) == 9
    dist = datasets.distribution_from_frames(d["A"], d["b"])
    assert dist.shape == (9, 10, 2)
    # first point of each distribution is the first frame origin
    for i in range(9):
        np.testing.assert_allclose(dist[i, 0], np.asarray(d["b"][i][0][0]))


@requires_reference
def test_mrf_reproduce_quality():
    """Transporting demo i onto demo k's frames must land near demo k
    (the benchmark's core claim for GPT)."""
    policy = MultipleReferenceFramesGPT(optimizer=None)
    policy.load_dataset()
    fdes, dfs = [], []
    for i, k in [(0, 4), (0, 1), (2, 7), (3, 5)]:
        df, area, dtw, fde, fda = policy.reproduce(i, k)
        assert np.isfinite([df, area, dtw, fde, fda]).all()
        fdes.append(fde)
        dfs.append(df)
    # individual pairs vary (some demo shapes differ a lot); the aggregate
    # must land near the target frame
    assert np.median(fdes) < 5.0, fdes
    assert np.median(dfs) < 20.0, dfs


@requires_reference
def test_mrf_ablation_small():
    out = ablation_study(number_repetitions=1, seed=0, ood=True)
    assert len(out["df"]) == 8  # 9 demos − 1 source
    assert len(out["fde_ood"]) == 9
    assert np.isfinite(out["fde"]).all()
    assert np.median(out["fde"]) < 5.0


def test_generate_frame_orientation_perturbs():
    A = [np.tile(np.eye(2), (1, 2, 1, 1))[None].reshape(1, 2, 2, 2) for _ in range(3)]
    b = [np.zeros((1, 2, 2)) for _ in range(3)]
    A2, b2 = datasets.generate_frame_orientation(A, b, np.random.RandomState(1))
    assert not np.allclose(np.asarray(A2[0][0][0]), np.eye(2))
    # rotations stay orthonormal
    R = np.asarray(A2[0][0][0])
    np.testing.assert_allclose(R @ R.T, np.eye(2), atol=1e-12)


# ---------------------------------------------------------------------------
# Surfaces comparison
# ---------------------------------------------------------------------------

def test_run_comparison_minimal():
    """Subset of methods on synthetic data: matrices have the right
    structure (zero diagonal for distances, PSD-ish KL ≥ 0 off-diag)."""
    from gaussian_process_transportation_tpu.transport import (
        GaussianProcessTransportation,
        LaplacianEditingTransport,
    )
    from gaussian_process_transportation_tpu import kernels as K

    t = np.linspace(0, 1, 80)
    demo = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, 30)
    source = np.stack([10 * s, np.zeros_like(s)], 1)
    target = np.stack([10 * s, 1 + np.sin(2 * s)], 1)

    methods = {
        "GPT": GaussianProcessTransportation(
            kernel_transport=K.Constant(1.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(1e-4),
            optimizer=None,
        ),
        "LE": LaplacianEditingTransport(),
    }
    out = run_comparison(demo, source, target, methods=methods, n_traj=50, n_dist=15)
    for key in ("divergence", "distribution_distance", "euclidean_distance"):
        M = out[key]
        assert M.shape == (2, 2)
        np.testing.assert_allclose(np.diag(M), 0.0, atol=1e-6)
    assert out["euclidean_distance"][0, 1] == out["euclidean_distance"][1, 0]
    assert out["divergence"][0, 1] >= 0


def test_mann_whitney_ranking():
    good = np.abs(np.random.RandomState(0).randn(50)) * 0.1
    bad = np.abs(np.random.RandomState(1).randn(50)) * 10 + 1
    ranked = mann_whitney_ranking({"good": good, "bad": bad})
    assert ranked[0][0] == "good" and ranked[0][1] < ranked[1][1]


def test_compare_methods_collects_cross_method_samples(tmp_path):
    """data_analysis_dataset.py data-collection half: same (source,
    target) pairs for every method, five metric tables out — on a seeded
    reach-target dataset in the reference file format."""
    from gaussian_process_transportation_tpu.benchmarks import (
        MultipleReferenceFramesGPT,
        MultipleReferenceFramesDMP,
        compare_methods,
    )

    methods = {
        "GPT": MultipleReferenceFramesGPT(optimizer=None),
        "DMP": MultipleReferenceFramesDMP(),
    }
    path = str(tmp_path / "reach_target.npy")
    np.save(path, datasets.make_reach_target(seed=0), allow_pickle=True)
    out = compare_methods(methods=methods, number_repetitions=1, path=path)
    assert set(out) == {
        "Frechet Distance", "Area btw curves", "Dynamic Time Warping",
        "Final Position Error", "Final Orientation Error",
    }
    for per in out.values():
        assert set(per) == {"GPT", "DMP"}
        for v in per.values():
            assert v.ndim == 1 and len(v) >= 5 and np.isfinite(v).all()


def test_ranking_report_and_boxplot(tmp_path):
    """Parity surface for data_analysis_dataset.py:23-99 — per-metric
    rankings as text plus the rank-ordered, rank-annotated box plots."""
    from gaussian_process_transportation_tpu.benchmarks.statistics import (
        ranked_boxplot,
        ranking_report,
    )

    rng = np.random.RandomState(0)
    metrics = {
        "Frechet Distance": {
            "GPT": np.abs(rng.randn(40)) * 0.1,
            "DMP": np.abs(rng.randn(40)) * 5 + 1,
            "HMM": np.abs(rng.randn(40)) * 2 + 0.5,
        },
        "Final Position Error": {
            "GPT": np.abs(rng.randn(40)) * 0.2,
            "DMP": np.abs(rng.randn(40)) * 3 + 1,
            "HMM": np.concatenate([np.abs(rng.randn(39)), [np.nan]]),
        },
    }
    report = ranking_report(metrics)
    lines = report.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("Frechet Distance: GPT(1)")

    out = str(tmp_path / "boxplot.png")
    fig, axes = ranked_boxplot(metrics, out_path=out)
    assert len(axes) == 2
    # methods appear ordered by rank with the rank annotated above each box
    labels = [t.get_text() for t in axes[0].get_xticklabels()]
    assert labels[0] == "GPT"
    import os

    assert os.path.exists(out)
    import matplotlib.pyplot as plt

    plt.close(fig)


def test_drawing_recorder_programmatic(tmp_path):
    from gaussian_process_transportation_tpu.data.drawing import DrawingRecorder

    rec = DrawingRecorder(interactive=False)
    t = np.linspace(0, 1, 30)
    rec.feed(np.stack([t * 10, np.sin(t)], 1))
    rec.mark_demo()
    rec.feed(np.stack([t * 10, -np.ones_like(t)], 1))
    rec.mark_floor()
    rec.feed(np.stack([t * 10, -1 + np.sin(2 * t)], 1))
    rec.mark_newfloor()
    path = str(tmp_path / "drawn.npz")
    rec.save(path)
    data = np.load(path)
    assert data["demo"].shape == (30, 2)
    assert data["floor"].shape == (30, 2)
    assert data["newfloor"].shape == (30, 2)


@requires_reference
def test_robot_analysis_on_committed_artifacts():
    """The reference commits the cleaning experiment's recorded target
    distributions; the analysis matrices must reproduce on them."""
    from gaussian_process_transportation_tpu.data import robot_analysis as ra
    from scipy.spatial import distance as sp_dist

    sets = ra.load_recorded_distributions(
        "/root/reference/robot_experiments/results/cleaning"
    )
    assert len(sets) >= 2
    out = ra.distribution_distance_matrices(sets[:3])
    n = min(3, len(sets))
    for key in ("hausdorff", "chamfer"):
        M = out[key]
        assert M.shape == (n, n)
        np.testing.assert_allclose(np.diag(M), 0.0, atol=1e-9)
    # golden check vs scipy directed_hausdorff (reference line 137)
    expected = max(
        sp_dist.directed_hausdorff(sets[0], sets[1])[0],
        sp_dist.directed_hausdorff(sets[1], sets[0])[0],
    )
    np.testing.assert_allclose(out["hausdorff"][0, 1], expected, rtol=1e-9)


@requires_reference
def test_lasa_loader():
    demos = datasets.load_lasa("Angle")
    assert len(demos) >= 3
    d = demos[0]
    assert d["pos"].shape[1] == 2 and d["vel"].shape == d["pos"].shape
    assert d["t"].shape[0] == d["pos"].shape[0]
    # velocities are consistent with positions (finite-difference check)
    dt = np.diff(d["t"]).mean()
    fd = np.gradient(d["pos"], axis=0) / dt
    corr = np.corrcoef(fd[:, 0], d["vel"][:, 0])[0, 1]
    assert corr > 0.95, corr
