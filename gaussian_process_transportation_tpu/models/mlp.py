"""MLP regressors and vmapped ensembles.

Replaces the reference's sklearn/torch MLPs
(``models/ensemble_nerual_network.py:4-30``, ``models/torch/neural_network.py:10-88``,
``models/torch/ensemble_neural_network.py:5-45``).  The key re-design:
an ensemble is NOT a Python list of models trained sequentially — member
parameters carry a leading ensemble axis and every member trains
simultaneously inside one ``lax.scan`` jit (`vmap` over the member axis),
so E members cost one batched matmul pipeline.

Derivatives (∂output/∂input Jacobians, used for velocity transport) are
exact forward-mode autodiff, batched over queries and members.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

Array = jax.Array


def init_params(key: Array, sizes: Sequence[int]) -> list:
    """He-initialized MLP parameters: list of (W, b)."""
    keys = jax.random.split(key, len(sizes) - 1)
    params = []
    for k, n_in, n_out in zip(keys, sizes[:-1], sizes[1:]):
        W = jax.random.normal(k, (n_in, n_out)) * math.sqrt(2.0 / n_in)
        params.append((W, jnp.zeros(n_out)))
    return params


def apply(params: list, x: Array) -> Array:
    h = x
    for W, b in params[:-1]:
        h = jax.nn.relu(h @ W + b)
    W, b = params[-1]
    return h @ W + b


def fit_params(
    params,
    X: Array,
    Y: Array,
    num_epochs: int = 200,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    key: Optional[Array] = None,
):
    """Adam(W) minibatch MSE training, one lax.scan jit for the whole run."""
    N = X.shape[0]
    key = jax.random.PRNGKey(0) if key is None else key
    batch_size = min(batch_size, N)
    steps_per_epoch = max(N // batch_size, 1)
    sched = jax.vmap(
        lambda k: jax.random.permutation(k, N)[: steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size
        )
    )(jax.random.split(key, num_epochs)).reshape(-1, batch_size)

    opt = optax.adamw(learning_rate, weight_decay=weight_decay)

    @jax.jit
    def train(params, sched):
        opt_state = opt.init(params)

        def step(carry, idx):
            params, opt_state = carry
            loss, g = jax.value_and_grad(
                lambda p: jnp.mean((apply(p, X[idx]) - Y[idx]) ** 2)
            )(params)
            updates, opt_state = opt.update(g, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, _), losses = jax.lax.scan(step, (params, opt_state), sched)
        return params, losses

    params, losses = train(params, sched)
    return params, losses


def jacobian_fn(params, x: Array) -> Array:
    """(Nq, P, D) exact input Jacobian."""
    return jax.vmap(jax.jacfwd(lambda xi: apply(params, xi)))(x)


class MLP:
    """Single network, reference interface
    (``models/torch/neural_network.py``)."""

    def __init__(self, hidden=(100, 100, 100, 100), seed: int = 0):
        self.hidden = tuple(hidden)
        self.seed = seed
        self.params = None

    def fit(self, X, Y, num_epochs: int = 200, **kw):
        X = jnp.asarray(X)
        Y = jnp.asarray(Y if np.ndim(Y) == 2 else np.asarray(Y)[:, None])
        sizes = (X.shape[1],) + self.hidden + (Y.shape[1],)
        self.params = init_params(jax.random.PRNGKey(self.seed), sizes)
        self.params, _ = fit_params(
            self.params, X, Y, num_epochs=num_epochs, key=jax.random.PRNGKey(self.seed + 1), **kw
        )
        return self

    def predict(self, x, return_std: bool = False):
        y = apply(self.params, jnp.asarray(x))
        if return_std:
            return y, jnp.zeros_like(y)
        return y

    def derivative(self, x, return_var: bool = False):
        J = jacobian_fn(self.params, jnp.asarray(x))
        if return_var:
            return J, jnp.zeros_like(J)
        return J

    def samples(self, x, n_samples: int = 10):
        """Deterministic model: repeated prediction (cf. the reference's
        deterministic samples in laplacian_editing.py:83-87)."""
        return jnp.repeat(self.predict(x)[None], n_samples, axis=0)


class EnsembleMLP:
    """Vmapped ensemble: mean/std predictions, mean/var Jacobians, member
    samples (reference ``Ensemble_NN`` / ``EnsembleNeuralNetwork``)."""

    def __init__(self, n_estimators: int = 10, hidden=(100, 100, 100, 100), seed: int = 0):
        self.n_estimators = n_estimators
        self.hidden = tuple(hidden)
        self.seed = seed
        self.params = None  # pytree with leading member axis

    def fit(self, X, Y, num_epochs: int = 200, batch_size: int = 32,
            learning_rate: float = 1e-3, weight_decay: float = 1e-4):
        X = jnp.asarray(X)
        Y = jnp.asarray(Y if np.ndim(Y) == 2 else np.asarray(Y)[:, None])
        sizes = (X.shape[1],) + self.hidden + (Y.shape[1],)
        keys = jax.random.split(jax.random.PRNGKey(self.seed), self.n_estimators)
        params = jax.vmap(lambda k: init_params(k, sizes))(keys)

        train_keys = jax.random.split(jax.random.PRNGKey(self.seed + 1), self.n_estimators)
        fit_one = lambda p, k: fit_params(
            p, X, Y, num_epochs=num_epochs, batch_size=batch_size,
            learning_rate=learning_rate, weight_decay=weight_decay, key=k,
        )[0]
        self.params = jax.vmap(fit_one)(params, train_keys)
        return self

    def _member_apply(self, x):
        return jax.vmap(lambda p: apply(p, x))(self.params)  # (E, Nq, P)

    def predict(self, x, return_std: bool = False):
        preds = self._member_apply(jnp.asarray(x))
        mean = preds.mean(axis=0)
        if return_std:
            return mean, preds.std(axis=0)
        return mean

    def derivative(self, x, return_var: bool = False):
        Js = jax.vmap(lambda p: jacobian_fn(p, jnp.asarray(x)))(self.params)  # (E,Nq,P,D)
        mean = Js.mean(axis=0)
        if return_var:
            return mean, Js.var(axis=0)
        return mean

    def samples(self, x):
        """(E, Nq, P): per-member predictions (reference Ensemble_NN.samples)."""
        return self._member_apply(jnp.asarray(x))
