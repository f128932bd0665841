"""Gaussian Process Transportation framework in JAX.

A JAX re-design of the capabilities of
``gaussian_process_transportation`` (TU Delft, arXiv:2404.13458): policy
transportation via affine + GP-residual maps with uncertainty-aware
position / velocity / orientation push-forward, sparse variational GPs,
alternative delta-map models, obstacle-avoidance modulation, and ensembles
and samplers sharded over a device mesh.
"""

import jax as _jax

# Float32 matmuls may otherwise run in a reduced-precision mode (TF32 on
# NVIDIA tensor cores: a 10-bit mantissa).  For GP numerics that is
# catastrophic, not just sloppy: the Gram matrix loses positive-
# definiteness and the Cholesky NaNs the whole pipeline, and the matmuls
# inside XLA's blocked cholesky/triangular-solve are equally affected,
# which per-dot precision overrides cannot reach.  So the whole package
# runs float32-accurate matmuls.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import kernels
from .models import (
    GaussianProcess,
    AffineTransform,
)
from .transport.gpt import GaussianProcessTransportation
from .utils.resample import resample

__all__ = [
    "kernels",
    "GaussianProcess",
    "AffineTransform",
    "GaussianProcessTransportation",
    "resample",
]

__version__ = "0.1.0"
