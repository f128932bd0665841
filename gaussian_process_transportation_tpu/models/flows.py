"""Invertible RealNVP coupling flows with exact Jacobians.

Replaces ``models/torch/bijective_neural_network.py:11-282`` (BijectionNet:
alternating-mask coupling layers, ELU scale/translate nets, hidden 20, 4
blocks, identity init; trained with SmoothL1 on source→target — i.e. the
flow fits Φ itself, not the residual) and the vmapped ensemble variant
(``models/torch/ensemble_bijective_network.py``).

Design notes: the exact flow Jacobian is one ``jacfwd`` through the whole
network (the chain-rule product the reference accumulates layer-by-layer
with autograd); ensembles batch over a leading member axis via ``vmap``
— E flows train as one program.  Coupling layers invert analytically,
giving the invertibility capability the diffeomorphic variant needs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

Array = jax.Array


from ..utils import pytree as struct


@struct.dataclass
class CouplingNet:
    """One scale/translate net.  ``kind`` is static: 'fcnn' (2 hidden ELU
    layers, reference FCNN) or 'rffn' (fixed random cos features +
    trainable readout, reference RFFN — bounded features ⇒ bounded
    extrapolation)."""

    layers: tuple  # ((W, b), ...)
    kind: str = struct.field(pytree_node=False, default="fcnn")


class CouplingParams(NamedTuple):
    """Trainable nets of one coupling layer.  The alternating binary mask is
    *structural* (recomputed from the layer index), deliberately NOT a pytree
    leaf — otherwise the optimizer/vmap would treat it as a parameter."""

    s_net: CouplingNet
    t_net: CouplingNet


def _init_net(key, sizes, kind: str = "fcnn", sigma: float = 0.45) -> CouplingNet:
    if kind == "rffn":
        in_dim, n_feat, out_dim = sizes[0], sizes[1], sizes[-1]
        k1, k2 = jax.random.split(key)
        coeff = jax.random.normal(k1, (in_dim, n_feat)) / sigma
        offset = 2.0 * math.pi * jax.random.uniform(k2, (n_feat,))
        W = jnp.zeros((n_feat, out_dim))  # identity init (reference zeroes it)
        return CouplingNet(layers=((coeff, offset), (W, jnp.zeros(out_dim))), kind="rffn")
    keys = jax.random.split(key, len(sizes) - 1)
    params = []
    for i, (k, n_in, n_out) in enumerate(zip(keys, sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        if last:
            W = jnp.zeros((n_in, n_out))  # identity init (reference init)
        else:
            # torch-default-style uniform ±1/√fan_in (reference uses torch
            # Linear defaults for the hidden layers)
            bound = 1.0 / math.sqrt(n_in)
            W = jax.random.uniform(k, (n_in, n_out), minval=-bound, maxval=bound)
        params.append((W, jnp.zeros(n_out)))
    return CouplingNet(layers=tuple(params), kind="fcnn")


def _net_apply(net: CouplingNet, x: Array) -> Array:
    if net.kind == "rffn":
        coeff, offset = net.layers[0]
        feats = jnp.cos(x @ jax.lax.stop_gradient(coeff) + jax.lax.stop_gradient(offset))
        W, b = net.layers[1]
        return feats @ W + b
    h = x
    for W, b in net.layers[:-1]:
        h = jax.nn.elu(h @ W + b)
    W, b = net.layers[-1]
    return h @ W + b


def _layer_mask(num_dims: int, i: int) -> Array:
    """Alternating pass-through mask of layer i (reference flips the mask
    between blocks, ``bijective_neural_network.py:84-92``)."""
    return ((jnp.arange(num_dims) + i) % 2).astype(jnp.float32)


def init_flow(
    key: Array,
    num_dims: int,
    num_blocks: int = 4,
    num_hidden: int = 20,
    kind: str = "fcnn",
    sigma: float = 0.45,
) -> list:
    """Alternating-mask coupling stack (reference BijectionNet.__init__)."""
    layers = []
    sizes = (num_dims, num_hidden, num_hidden, num_dims)
    for i in range(num_blocks):
        ks, kt = jax.random.split(jax.random.fold_in(key, i))
        layers.append(
            CouplingParams(
                s_net=_init_net(ks, sizes, kind, sigma),
                t_net=_init_net(kt, sizes, kind, sigma),
            )
        )
    return layers


_S_CAP = 4.0  # soft clamp on log-scales: keeps exp(s) bounded under
#               extrapolation far outside the training support


def _coupling_forward(p: CouplingParams, mask: Array, x: Array) -> Array:
    xm = x * mask
    s = _S_CAP * jnp.tanh(_net_apply(p.s_net, xm) / _S_CAP) * (1.0 - mask)
    t = _net_apply(p.t_net, xm) * (1.0 - mask)
    return xm + (1.0 - mask) * (x * jnp.exp(s) + t)


def _coupling_inverse(p: CouplingParams, mask: Array, y: Array) -> Array:
    ym = y * mask  # pass-through half unchanged
    s = _S_CAP * jnp.tanh(_net_apply(p.s_net, ym) / _S_CAP) * (1.0 - mask)
    t = _net_apply(p.t_net, ym) * (1.0 - mask)
    return ym + (1.0 - mask) * ((y - t) * jnp.exp(-s))


def flow_forward(layers: list, x: Array) -> Array:
    """x: (D,) or (N, D)."""
    d = x.shape[-1]
    for i, p in enumerate(layers):
        x = _coupling_forward(p, _layer_mask(d, i), x)
    return x


def flow_inverse(layers: list, y: Array) -> Array:
    d = y.shape[-1]
    for i, p in reversed(list(enumerate(layers))):
        y = _coupling_inverse(p, _layer_mask(d, i), y)
    return y


def flow_jacobian(layers: list, x: Array) -> Array:
    """Exact ∂Φ/∂x, (N, D, D), via forward-mode through the full stack."""
    return jax.vmap(jax.jacfwd(lambda xi: flow_forward(layers, xi)))(x)


def fit_flow(
    layers: list,
    X: Array,
    Y: Array,
    num_epochs: int = 200,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    key: Optional[Array] = None,
):
    """SmoothL1 (Huber) regression of the flow onto (X→Y), as the reference
    trains it (``bijective_neural_network.py:36-56``)."""
    N = X.shape[0]
    key = jax.random.PRNGKey(0) if key is None else key
    batch_size = min(batch_size, N)
    steps_per_epoch = max(N // batch_size, 1)
    sched = jax.vmap(
        lambda k: jax.random.permutation(k, N)[: steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size
        )
    )(jax.random.split(key, num_epochs)).reshape(-1, batch_size)

    opt = optax.adam(learning_rate)

    @jax.jit
    def train(layers, sched):
        opt_state = opt.init(layers)

        def step(carry, idx):
            layers, opt_state = carry
            loss, g = jax.value_and_grad(
                lambda ls: jnp.mean(
                    optax.losses.huber_loss(flow_forward(ls, X[idx]), Y[idx])
                )
            )(layers)
            updates, opt_state = opt.update(g, opt_state, layers)
            return (optax.apply_updates(layers, updates), opt_state), loss

        (layers, _), losses = jax.lax.scan(step, (layers, opt_state), sched)
        return layers, losses

    return train(layers, sched)


def _shared_standardizer(X: Array, Y: Array):
    """Mean + ISOTROPIC scale over X∪Y: normalizing both sides with the
    same affine map keeps the identity-initialized flow an exact identity
    while bringing raw robot-workspace coordinates (~±50) into the net's
    stable range.  The scale is deliberately scalar: per-dimension std of
    a thin surface band (e.g. a floor: σ_y ≈ 0) would blow query points a
    few units off the band up to ~100σ and make extrapolation explode."""
    both = jnp.concatenate([X, Y], axis=0)
    mu = both.mean(axis=0)
    sd = jnp.sqrt(jnp.mean(jnp.sum((both - mu) ** 2, axis=1))) + 1e-8
    return mu, jnp.full((X.shape[1],), sd)


class BijectiveNetwork:
    """Reference interface: fit Φ directly on (X=source, Y=target)."""

    def __init__(self, X, Y, num_blocks: int = 4, num_hidden: int = 20, seed: int = 0,
                 kind: str = "fcnn", sigma: float = 0.45):
        self.X = jnp.asarray(X)
        self.Y = jnp.asarray(Y)
        self.seed = seed
        self.mu, self.sd = _shared_standardizer(self.X, self.Y)
        self.layers = init_flow(
            jax.random.PRNGKey(seed), self.X.shape[1], num_blocks, num_hidden,
            kind=kind, sigma=sigma,
        )

    def _norm(self, x):
        return (jnp.asarray(x) - self.mu) / self.sd

    def _denorm(self, z):
        return z * self.sd + self.mu

    def fit(self, num_epochs: int = 200, **kw):
        self.layers, _ = fit_flow(
            self.layers, self._norm(self.X), self._norm(self.Y), num_epochs=num_epochs,
            key=jax.random.PRNGKey(self.seed + 1), **kw
        )
        return self

    def predict(self, x):
        return self._denorm(flow_forward(self.layers, self._norm(x)))

    def inverse(self, y):
        return self._denorm(flow_inverse(self.layers, self._norm(y)))

    def derivative(self, x):
        J = flow_jacobian(self.layers, self._norm(x))
        # Φ = denorm ∘ f ∘ norm ⇒ J_Φ = diag(sd) J_f diag(1/sd)
        return self.sd[None, :, None] * J / self.sd[None, None, :]


class EnsembleBijectiveNetwork:
    """Vmapped flow ensemble (reference
    ``models/torch/ensemble_bijective_network.py:5-45``): mean/std of
    predictions, mean/var of Jacobians, member samples."""

    def __init__(self, X, Y, n_estimators: int = 10, num_blocks: int = 4,
                 num_hidden: int = 20, seed: int = 0, kind: str = "fcnn",
                 sigma: float = 0.45):
        self.X = jnp.asarray(X)
        self.Y = jnp.asarray(Y)
        self.n_estimators = n_estimators
        self.mu, self.sd = _shared_standardizer(self.X, self.Y)
        keys = jax.random.split(jax.random.PRNGKey(seed), n_estimators)
        self.layers = jax.vmap(
            lambda k: init_flow(k, self.X.shape[1], num_blocks, num_hidden,
                                kind=kind, sigma=sigma)
        )(keys)
        self.seed = seed

    def _norm(self, x):
        return (jnp.asarray(x) - self.mu) / self.sd

    def _denorm(self, z):
        return z * self.sd + self.mu

    def fit(self, num_epochs: int = 200, **kw):
        keys = jax.random.split(jax.random.PRNGKey(self.seed + 1), self.n_estimators)
        Xn, Yn = self._norm(self.X), self._norm(self.Y)
        self.layers = jax.vmap(
            lambda ls, k: fit_flow(ls, Xn, Yn, num_epochs=num_epochs, key=k, **kw)[0]
        )(self.layers, keys)
        return self

    def predict(self, x, return_std: bool = False):
        xn = self._norm(x)
        preds = jax.vmap(lambda ls: self._denorm(flow_forward(ls, xn)))(self.layers)
        mean = preds.mean(0)
        if return_std:
            return mean, preds.std(0)
        return mean

    def derivative(self, x, return_var: bool = False):
        xn = self._norm(x)
        Js = jax.vmap(
            lambda ls: self.sd[None, :, None]
            * flow_jacobian(ls, xn)
            / self.sd[None, None, :]
        )(self.layers)
        mean = Js.mean(0)
        if return_var:
            return mean, Js.var(0)
        return mean

    def samples(self, x):
        xn = self._norm(x)
        return jax.vmap(lambda ls: self._denorm(flow_forward(ls, xn)))(self.layers)
