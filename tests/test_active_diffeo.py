"""Active-learning subset selection + diffeomorphic transport variant."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models.gp_active import (
    GaussianProcessActiveLearning,
    greedy_variance_select,
)
from gaussian_process_transportation_tpu.transport.diffeo import (
    GaussianProcessTransportationDiffeo,
)

rng = np.random.RandomState(6)


def test_greedy_selection_is_space_filling():
    """Greedy max-variance selection with an RBF kernel must spread points
    out — no two selected points should be much closer than the typical
    nearest-neighbor distance of a uniform design."""
    X = jnp.asarray(rng.rand(500, 2))
    kernel = K.Constant(1.0) * K.RBF(0.2 * jnp.ones(2)) + K.White(0.01)
    idx = np.asarray(greedy_variance_select(kernel, X, 30, jnp.asarray([0]), noise=0.01))
    assert len(set(idx.tolist())) == 30  # distinct
    sel = np.asarray(X)[idx]
    from scipy.spatial.distance import pdist

    min_dist = pdist(sel).min()
    assert min_dist > 0.05, min_dist  # greedy spreads; random would clump


def test_greedy_selection_matches_exact_posterior_variance():
    """Each greedily-added point must be the argmax of the exact GP
    posterior variance given previously selected points."""
    X = jnp.asarray(rng.rand(60, 1) * 4)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(1) * 0.5) + K.White(0.01)
    idx = np.asarray(greedy_variance_select(kernel, X, 5, jnp.asarray([7]), noise=0.01))

    from gaussian_process_transportation_tpu.models import exact_gp as core

    for j in range(1, 5):
        sel = idx[:j]
        gp = core.condition(kernel, X[sel], jnp.zeros((j, 1)))
        _, std = core.predict(gp, X, return_std=True)
        var = np.asarray(std[:, 0]) ** 2
        var[sel] = -np.inf
        # the selected point must attain the max posterior variance (up to
        # exact fp ties between points far outside the lengthscale support)
        assert var[idx[j]] >= var.max() - 1e-10, (j, var[idx[j]], var.max())


def test_active_learning_wrapper_subsamples():
    N = 600
    X = rng.rand(N, 2) * 10
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1)
    m = GaussianProcessActiveLearning(
        K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01),
        n_samples_max=100,
        n_restarts_optimizer=0,
    )
    m.fit(X, Y)
    assert m.state.X.shape[0] == 100
    mean, std = m.predict(X[:50])
    assert mean.shape == (50, 2)
    rmse = np.sqrt(np.mean((np.asarray(mean) - Y[:50]) ** 2))
    assert rmse < 0.2, rmse
    dy, ds = m.derivative(X[:5])
    assert dy.shape == (5, 2, 2) and ds.shape == (5, 2, 1)


def test_active_learning_blocked_fit_route():
    """use_blocked=True routes the subset hyperopt through the panel-LML
    fit (fit_blocked) — the large-N path, exercised here at a small cap."""
    N = 500
    X = (rng.rand(N, 2) * 4 - 2).astype(np.float32)
    Y = np.stack([np.sin(1.5 * X[:, 0]), np.cos(0.7 * X[:, 1])], 1).astype(
        np.float32
    ) + 0.05 * rng.randn(N, 2).astype(np.float32)
    m = GaussianProcessActiveLearning(
        K.Constant(1.0, bounds=(1e-3, 1e3))
        * K.RBF(jnp.ones(2, jnp.float32), bounds=(1e-2, 1e2))
        + K.White(0.1, bounds=(1e-6, 10.0)),
        n_samples_max=256,
        use_blocked=True,
        blocked_kwargs=dict(block=128, maxiter=10),
    )
    m.fit(X, Y)
    assert m.state.X.shape[0] == 256
    assert m.state.chol is not None and m.state.L is None  # panel form
    mean, std = m.predict(X[:50])
    rmse = np.sqrt(np.mean((np.asarray(mean) - Y[:50]) ** 2))
    assert rmse < 0.25, rmse
    dy, ds = m.derivative(X[:5])
    assert dy.shape == (5, 2, 2) and ds.shape == (5, 2, 1)
    assert np.isfinite(np.asarray(dy)).all() and np.isfinite(np.asarray(ds)).all()


def _problem():
    t = np.linspace(0, 1, 50)
    X = np.stack([10 * t, 3 + 2 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, 15)
    S = np.stack([10 * s, np.zeros_like(s)], 1)
    S1 = np.stack([10 * s, 1.5 + np.sin(2 * s)], 1)
    return X, S, S1


def test_check_invertibility_small_for_smooth_map():
    X, S, S1 = _problem()
    tr = GaussianProcessTransportationDiffeo(
        kernel_transport=K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.0001),
        optimizer=None,
    )
    tr.source_distribution, tr.target_distribution, tr.training_traj = S, S1, X
    tr.fit_transportation()
    err = tr.check_invertibility()
    # gentle deformation → forward∘inverse residual small per point
    assert err / len(X) < 0.5, err


def test_optimize_diffeomorphism_improves_or_matches():
    X, S, S1 = _problem()
    tr = GaussianProcessTransportationDiffeo(optimizer=None)
    tr.source_distribution, tr.target_distribution, tr.training_traj = S, S1, X
    err0 = tr.diffeomorphism_error(2.0)
    best = tr.optimize_diffeomorphism(n_trials=5)
    best_err = min(tr.diffeo_errors.values())
    assert best_err <= err0 + 1e-9
    assert 2.0 <= best <= 20.0


def test_save_load_distributions(tmp_path):
    X, S, S1 = _problem()
    tr = GaussianProcessTransportationDiffeo(optimizer=None)
    tr.source_distribution, tr.target_distribution, tr.training_traj = S, S1, X
    tr.save_distributions(str(tmp_path))
    tr2 = GaussianProcessTransportationDiffeo(optimizer=None)
    tr2.load_distributions(str(tmp_path))
    np.testing.assert_allclose(np.asarray(tr2.source_distribution), S)
    np.testing.assert_allclose(np.asarray(tr2.target_distribution), S1)
