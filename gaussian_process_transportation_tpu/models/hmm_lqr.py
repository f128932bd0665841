"""HMM over task-parameterized (x, ẋ) features + LQR reproduction.

JAX equivalent of the reference's pbdlib baseline
(``models/model_hmm.py:1-40``: ``pbdlib.hmm.HMM(nb_states=5, nb_dim=8)``
on per-frame position+velocity views, reproduced with ``pbdlib.poglqr.PoGLQR``):

* emissions: per-state, per-frame Gaussians over ξ^{(j)} = [x^{(j)}, ẋ^{(j)}]
  (frame views multiply in the likelihood, as in TP-GMM);
* EM with exact forward–backward (``lax.scan``) for the temporal structure;
* reproduction: per-frame Gaussians map to a new frame configuration with
  Ã = blkdiag(A, A), b̃ = [b, 0]; the product over frames gives per-state
  step targets; a discrete LQR (double-integrator dynamics, Q_t = Σ⁻¹ of
  the active state, backward Riccati scan + forward rollout) tracks the
  deterministic state sequence.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class HMMParams(NamedTuple):
    init: Array  # (K,)
    trans: Array  # (K, K)
    mu: Array  # (F, K, D) per-frame emission means
    sigma: Array  # (F, K, D, D)


def _logpdf(x, mu, sigma):
    d = x.shape[-1]
    L = jnp.linalg.cholesky(sigma)
    diff = jax.scipy.linalg.solve_triangular(L, x - mu, lower=True)
    return -0.5 * jnp.sum(diff**2) - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * d * jnp.log(2 * jnp.pi)


def _emission_loglik(params: HMMParams, seq: Array) -> Array:
    """seq: (T, F, D) → (T, K) summed-over-frames emission log-likelihood."""
    F = seq.shape[1]

    def per_state(mu_k, sigma_k):  # (F, D), (F, D, D)
        def at_t(xs):  # (F, D)
            return jnp.sum(
                jnp.stack([_logpdf(xs[f], mu_k[f], sigma_k[f]) for f in range(F)])
            )

        return jax.vmap(at_t)(seq)

    return jax.vmap(per_state, in_axes=(1, 1))(params.mu, params.sigma).T  # (T, K)


def _forward_backward(log_b: Array, init: Array, trans: Array):
    """Scaled forward-backward.  log_b: (T, K).  Returns (gamma (T,K),
    xi_sum (K,K), loglik)."""
    T, K = log_b.shape
    log_init = jnp.log(init + 1e-30)
    log_trans = jnp.log(trans + 1e-30)

    def fwd(carry, lb):
        log_alpha = carry
        new = lb + jax.scipy.special.logsumexp(log_alpha[:, None] + log_trans, axis=0)
        return new, new

    log_alpha0 = log_init + log_b[0]
    _, log_alphas = jax.lax.scan(fwd, log_alpha0, log_b[1:])
    log_alphas = jnp.concatenate([log_alpha0[None], log_alphas])

    def bwd(carry, lb):
        log_beta_next = carry
        new = jax.scipy.special.logsumexp(
            log_trans + (lb + log_beta_next)[None, :], axis=1
        )
        return new, new

    _, log_betas_rev = jax.lax.scan(bwd, jnp.zeros(K), log_b[1:][::-1])
    log_betas = jnp.concatenate([log_betas_rev[::-1], jnp.zeros((1, K))])

    loglik = jax.scipy.special.logsumexp(log_alphas[-1])
    log_gamma = log_alphas + log_betas - loglik
    gamma = jnp.exp(log_gamma)

    # xi summed over time
    log_xi = (
        log_alphas[:-1, :, None]
        + log_trans[None]
        + (log_b[1:] + log_betas[1:])[:, None, :]
        - loglik
    )
    xi_sum = jnp.exp(jax.scipy.special.logsumexp(log_xi, axis=0))
    return gamma, xi_sum, loglik


class HMMLQR:
    def __init__(self, n_states: int = 5, n_iter: int = 25, reg: float = 1e-2, dt: float = 1.0):
        self.n_states = n_states
        self.n_iter = n_iter
        self.reg = reg
        self.dt = dt
        self.params: Optional[HMMParams] = None

    def fit(self, demos_x: List[np.ndarray], demos_dx: List[np.ndarray], A: List, b: List):
        """Per-frame views ξ^{(j)} = A_j⁻¹[x − b_j ; ẋ]."""
        F = len(A[0][0])
        d = demos_x[0].shape[1]
        seqs = []
        for i in range(len(demos_x)):
            X, dX = np.asarray(demos_x[i]), np.asarray(demos_dx[i])
            views = []
            for f in range(F):
                Ainv = np.linalg.inv(np.asarray(A[i][0][f]))
                xf = (Ainv @ (X - np.asarray(b[i][0][f])).T).T
                dxf = (Ainv @ dX.T).T
                views.append(np.concatenate([xf, dxf], axis=1))
            seqs.append(np.stack(views, axis=1))  # (T, F, 2d)
        seqs = [jnp.asarray(s) for s in seqs]
        self.dim = d
        self.n_frames = F
        self.T_demo = seqs[0].shape[0]

        K = self.n_states
        D = 2 * d
        # init: uniform time segmentation (per demo — lengths may differ)
        concat = jnp.concatenate(seqs, axis=0)  # (N, F, D)
        mu0 = np.zeros((F, K, D))
        sigma0 = np.zeros((F, K, D, D))
        all_np = np.concatenate([np.asarray(s) for s in seqs], axis=0)
        all_seg = np.concatenate(
            [np.minimum((np.arange(s.shape[0]) * K) // s.shape[0], K - 1) for s in seqs]
        )
        for f in range(F):
            for k in range(K):
                pts = all_np[all_seg == k][:, f, :]
                mu0[f, k] = pts.mean(0)
                sigma0[f, k] = np.cov(pts.T) + self.reg * np.eye(D)
        trans0 = 0.9 * np.eye(K) + 0.1 * np.eye(K, k=1)
        trans0[-1, -1] = 1.0
        trans0 = trans0 / trans0.sum(1, keepdims=True)
        params = HMMParams(
            init=jnp.ones(K).at[0].set(K * 1.0) / (2 * K - 1),
            trans=jnp.asarray(trans0),
            mu=jnp.asarray(mu0),
            sigma=jnp.asarray(sigma0),
        )

        @jax.jit
        def em_step(params):
            gammas, xis, inits = [], [], []
            for s in seqs:
                log_b = _emission_loglik(params, s)
                g, x, _ = _forward_backward(log_b, params.init, params.trans)
                gammas.append(g)
                xis.append(x)
                inits.append(g[0])
            gamma = jnp.concatenate(gammas, axis=0)  # (N, K)
            xi = sum(xis)
            init = sum(inits) / len(seqs)
            trans = xi / jnp.maximum(xi.sum(1, keepdims=True), 1e-30)
            nk = gamma.sum(0) + 1e-10

            def update_frame(f):
                x = concat[:, f, :]
                mu = (gamma.T @ x) / nk[:, None]

                def cov_k(k):
                    from .tpgmm import eigenvalue_floor

                    diff = x - mu[k]
                    cov = (gamma[:, k][:, None] * diff).T @ diff / nk[k] + self.reg * jnp.eye(D)
                    # guard against spurious precision from near-singular
                    # few-demo covariances (see tpgmm.eigenvalue_floor)
                    return eigenvalue_floor(cov, 0.02)

                return mu, jax.vmap(cov_k)(jnp.arange(K))

            mus, sigmas = zip(*[update_frame(f) for f in range(F)])
            return HMMParams(init=init, trans=trans, mu=jnp.stack(mus), sigma=jnp.stack(sigmas))

        for _ in range(self.n_iter):
            params = em_step(params)
        self.params = params
        return self

    def state_sequence(self, T: int) -> Array:
        """Deterministic most-likely progression: argmax of the propagated
        transition dynamics (no observations) — the timeline PoGLQR tracks."""
        p = self.params

        def step(prob, _):
            prob = prob @ p.trans
            return prob, jnp.argmax(prob)

        prob0 = p.init
        _, s_rest = jax.lax.scan(step, prob0, None, length=T - 1)
        return jnp.concatenate([jnp.argmax(prob0)[None], s_rest])

    def reproduce(self, A_new, b_new, x0: np.ndarray, T: Optional[int] = None) -> np.ndarray:
        """LQR-tracked trajectory from x0 under a new frame configuration."""
        p = self.params
        K, F, d = self.n_states, self.n_frames, self.dim
        D = 2 * d
        T = T or self.T_demo

        def to_global(f):
            A_f = jnp.asarray(A_new[f])
            b_f = jnp.asarray(b_new[f])
            Ax = jnp.zeros((D, D)).at[:d, :d].set(A_f).at[d:, d:].set(A_f)
            off = jnp.concatenate([b_f, jnp.zeros(d)])
            mu_g = (Ax @ p.mu[f].T).T + off
            sigma_g = jnp.einsum("ab,kbc,dc->kad", Ax, p.sigma[f], Ax)
            return mu_g, sigma_g

        mus, sigmas = zip(*[to_global(f) for f in range(F)])

        def product(k):
            precs = [jnp.linalg.inv(sigmas[f][k]) for f in range(F)]
            P = sum(precs)
            S = jnp.linalg.inv(P)
            m = S @ sum(precs[f] @ mus[f][k] for f in range(F))
            return m, S

        mu_p, sigma_p = jax.vmap(product)(jnp.arange(K))

        seq = self.state_sequence(T)  # (T,)
        targets = mu_p[seq]  # (T, D)
        Q = jnp.linalg.inv(sigma_p)[seq]  # (T, D, D)

        dt = self.dt
        A_sys = jnp.eye(D).at[:d, d:].set(dt * jnp.eye(d))
        B_sys = jnp.zeros((D, d)).at[d:, :].set(dt * jnp.eye(d))
        R = 1e-2 * jnp.eye(d)

        # backward Riccati with time-varying Q around time-varying targets
        def backward(carry, inputs):
            P_next, v_next = carry
            Qt, xt = inputs
            BtP = B_sys.T @ P_next
            Kgain = jnp.linalg.solve(R + BtP @ B_sys, BtP @ A_sys)
            Acl = A_sys - B_sys @ Kgain
            P = Qt + A_sys.T @ P_next @ Acl
            kff = jnp.linalg.solve(R + BtP @ B_sys, B_sys.T @ v_next)
            v = Qt @ xt + Acl.T @ v_next
            return (P, v), (Kgain, kff)

        (P_T, v_T) = (Q[-1], Q[-1] @ targets[-1])
        (_, _), (Ks, kffs) = jax.lax.scan(
            backward, (P_T, v_T), (Q[:-1][::-1], targets[:-1][::-1])
        )
        Ks = Ks[::-1]
        kffs = kffs[::-1]

        def forward(x, inputs):
            Kt, kf = inputs
            u = -Kt @ x + kf
            x_new = A_sys @ x + B_sys @ u
            return x_new, x_new

        xi0 = jnp.concatenate([jnp.asarray(x0), jnp.zeros(d)])
        _, traj = jax.lax.scan(forward, xi0, (Ks, kffs))
        traj = jnp.concatenate([xi0[None], traj], axis=0)
        return np.asarray(traj[:, :d])
