"""Task-Parameterized GMM with Gaussian Mixture Regression (TP-GMM/GMR).

The reference's multi-reference-frame benchmark compares GPT against a
TP-GMM baseline backed by the external ``tp_gmm`` package
(``models/model_tp_gmm.py:3-5``) and an HMM baseline backed by ``pbdlib``
(``model_hmm.py:3-4``).  This module provides the JAX equivalent:

* Calinon-style TP-GMM: each mixture state k keeps a per-frame Gaussian
  (μ_k^{(j)}, Σ_k^{(j)}) over features [t, x^{(j)}] where x^{(j)} is the
  demo projected into frame j; EM responsibilities use the product of
  frame likelihoods.
* Reproduction in a new frame configuration: per-state Gaussians map to
  the global frame (μ̂ = A μ + b, Σ̂ = A Σ Aᵀ), the product over frames is
  taken per state, and GMR conditions on time to yield the trajectory with
  per-step covariance.

All EM steps are jitted/vmapped; states/frames are batch axes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class TPGMMParams(NamedTuple):
    priors: Array  # (K,)
    mu: Array  # (F, K, D) per-frame state means over [t, x]
    sigma: Array  # (F, K, D, D)


def eigenvalue_floor(sigma: Array, floor_ratio: float) -> Array:
    """Clamp each covariance's eigenvalues to ≥ floor_ratio · λ_max.

    With few demonstrations, per-frame sample covariances are frequently
    near-singular; their spurious precision along the thin direction then
    dominates the product of frame Gaussians and wrecks reproduction (the
    same pathology pbdlib mitigates with its ``reg`` parameter)."""
    w, v = jnp.linalg.eigh(sigma)
    w = jnp.maximum(w, floor_ratio * jnp.max(w, axis=-1, keepdims=True))
    return jnp.einsum("...ab,...b,...cb->...ac", v, w, v)


def _gauss_logpdf(x, mu, sigma):
    d = x.shape[-1]
    L = jnp.linalg.cholesky(sigma)
    diff = jax.scipy.linalg.solve_triangular(L, (x - mu), lower=True)
    return (
        -0.5 * jnp.sum(diff**2)
        - jnp.sum(jnp.log(jnp.diagonal(L)))
        - 0.5 * d * jnp.log(2 * jnp.pi)
    )


def _em_fit(data_f: Array, n_states: int, n_iter: int, key: Array, reg: float,
            eig_floor: float = 0.05) -> TPGMMParams:
    """data_f: (F, N, D) frame-local feature views of N datapoints."""
    F, N, D = data_f.shape

    # init: slice time uniformly into K segments (standard TP-GMM init)
    t = data_f[0, :, 0]
    order = jnp.argsort(t)
    seg = jnp.array_split(np.asarray(order), n_states)
    mu0 = jnp.stack(
        [jnp.stack([data_f[f][jnp.asarray(s)].mean(0) for s in seg]) for f in range(F)]
    )  # (F, K, D)
    sigma0 = jnp.stack(
        [
            jnp.stack(
                [
                    jnp.cov(data_f[f][jnp.asarray(s)].T) + reg * jnp.eye(D)
                    for s in seg
                ]
            )
            for f in range(F)
        ]
    )
    params = TPGMMParams(priors=jnp.ones(n_states) / n_states, mu=mu0, sigma=sigma0)

    @jax.jit
    def em_step(params: TPGMMParams):
        # E-step: log responsibilities with product over frames
        def state_loglik(mu_k, sigma_k):  # mu_k: (F, D)
            def frame_ll(f):
                return jax.vmap(lambda x: _gauss_logpdf(x, mu_k[f], sigma_k[f]))(
                    data_f[f]
                )

            return jnp.sum(jnp.stack([frame_ll(f) for f in range(F)]), axis=0)  # (N,)

        ll = jax.vmap(state_loglik, in_axes=(1, 1))(params.mu, params.sigma)  # (K, N)
        log_r = jnp.log(params.priors)[:, None] + ll
        log_r = log_r - jax.scipy.special.logsumexp(log_r, axis=0, keepdims=True)
        r = jnp.exp(log_r)  # (K, N)

        # M-step
        nk = jnp.sum(r, axis=1) + 1e-10  # (K,)
        priors = nk / N

        def update_frame(f):
            x = data_f[f]  # (N, D)
            mu = (r @ x) / nk[:, None]  # (K, D)

            def state_cov(k):
                diff = x - mu[k]
                cov = (r[k][:, None] * diff).T @ diff / nk[k] + reg * jnp.eye(D)
                return eigenvalue_floor(cov, eig_floor)

            sigma = jax.vmap(state_cov)(jnp.arange(n_states))
            return mu, sigma

        mus, sigmas = [], []
        for f in range(F):
            m, s = update_frame(f)
            mus.append(m)
            sigmas.append(s)
        return TPGMMParams(priors=priors, mu=jnp.stack(mus), sigma=jnp.stack(sigmas))

    for _ in range(n_iter):
        params = em_step(params)
    return params


class TPGMM:
    """Task-parameterized GMM over [t, x] with per-frame views."""

    def __init__(self, n_states: int = 3, n_data: int = 40, n_iter: int = 30,
                 reg: float = 1e-2, eig_floor: float = 0.1, seed: int = 0):
        self.n_states = n_states
        self.n_data = n_data
        self.n_iter = n_iter
        self.reg = reg
        self.eig_floor = eig_floor
        self.seed = seed
        self.params: Optional[TPGMMParams] = None

    def fit(self, demos_x: List[np.ndarray], A: List, b: List):
        """demos_x: list of (T_i, d) trajectories; A[i][0][j]/b[i][0][j] the
        frame rotations/origins of demo i, frame j."""
        from ..utils.resample import resample

        d = demos_x[0].shape[1]
        F = len(A[0][0])
        # isotropic position scale so time (∈[0,1]) and positions (robot
        # workspace, ~±50) are commensurate — required for the eigenvalue
        # floor to be meaningful across the mixed [t, x] feature
        all_x = np.concatenate([np.asarray(X) for X in demos_x])
        self.x_scale = float(np.std(all_x)) + 1e-12
        views = []
        for f in range(F):
            rows = []
            for i, X in enumerate(demos_x):
                Xr = np.asarray(resample(jnp.asarray(X), num_points=self.n_data))
                t = np.linspace(0, 1, self.n_data)[:, None]
                A_f = np.asarray(A[i][0][f])
                b_f = np.asarray(b[i][0][f])
                x_local = (np.linalg.inv(A_f) @ (Xr - b_f).T).T / self.x_scale
                rows.append(np.column_stack([t, x_local]))
            views.append(np.concatenate(rows, axis=0))
        data_f = jnp.asarray(np.stack(views))  # (F, N, 1+d)
        self.dim = d
        self.n_frames = F
        self.params = _em_fit(
            data_f, self.n_states, self.n_iter, jax.random.PRNGKey(self.seed),
            self.reg, self.eig_floor,
        )
        return self

    def reproduce(self, A_new, b_new, n_points: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Trajectory (+ per-step covariance) under a new frame config.

        A_new/b_new: per-frame (d, d) rotations and (d,) origins."""
        p = self.params
        K, F, d = self.n_states, self.n_frames, self.dim
        n_points = n_points or self.n_data

        # map per-frame Gaussians to the global frame (in position-scaled
        # coordinates); time dim untouched
        def to_global(f):
            A_f = jnp.asarray(A_new[f])
            b_f = jnp.asarray(b_new[f]) / self.x_scale
            T = jnp.zeros((d + 1, d + 1)).at[0, 0].set(1.0).at[1:, 1:].set(A_f)
            off = jnp.concatenate([jnp.zeros(1), b_f])
            mu_g = (T @ p.mu[f].T).T + off  # (K, D)
            sigma_g = jnp.einsum("ab,kbc,dc->kad", T, p.sigma[f], T)
            return mu_g, sigma_g

        mus, sigmas = zip(*[to_global(f) for f in range(F)])

        # product of Gaussians across frames per state
        def product(k):
            precisions = [jnp.linalg.inv(sigmas[f][k]) for f in range(F)]
            P = sum(precisions)
            Sigma = jnp.linalg.inv(P)
            mu = Sigma @ sum(
                precisions[f] @ mus[f][k] for f in range(F)
            )
            return mu, Sigma

        mu_p, sigma_p = jax.vmap(product)(jnp.arange(K))  # (K, D), (K, D, D)

        # GMR: condition on time
        ts = jnp.linspace(0.0, 1.0, n_points)

        def gmr(t):
            mu_t = mu_p[:, 0]
            var_t = sigma_p[:, 0, 0]
            log_h = jnp.log(p.priors) - 0.5 * (t - mu_t) ** 2 / var_t - 0.5 * jnp.log(
                2 * jnp.pi * var_t
            )
            log_h = log_h - jax.scipy.special.logsumexp(log_h)
            h = jnp.exp(log_h)  # (K,)
            cond_mu = mu_p[:, 1:] + (
                sigma_p[:, 1:, 0] / var_t[:, None]
            ) * (t - mu_t)[:, None]  # (K, d)
            mean = jnp.sum(h[:, None] * cond_mu, axis=0)
            cond_cov = sigma_p[:, 1:, 1:] - jnp.einsum(
                "ka,kb->kab", sigma_p[:, 1:, 0], sigma_p[:, 1:, 0]
            ) / var_t[:, None, None]
            cov = jnp.sum(
                h[:, None, None]
                * (cond_cov + jnp.einsum("ka,kb->kab", cond_mu - mean, cond_mu - mean)),
                axis=0,
            )
            return mean, cov

        means, covs = jax.vmap(gmr)(ts)
        return (
            np.asarray(means) * self.x_scale,
            np.asarray(covs) * self.x_scale**2,
        )
