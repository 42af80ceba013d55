"""Linear-algebra kernels for the ADMM framework.

Replaces the reference's native compute layer — BLAS/LAPACK wrappers
(reference: src/Linalg/BlasWrapper.h, src/Linalg/LapackWrapper.h), the
AVX kernels (reference: src/Linalg/AVX.h) and the vendored Spectra
eigensolver (reference: src/Spectra/) — with XLA matmuls and on-device
power iteration.
"""
from __future__ import annotations

from functools import partial

import jax.numpy as jnp
from jax import lax

from .power_iter import (power_iteration, spectral_radius_gram,
                         spectral_radius_sym)
from .spd import chol_inverse, ridge_inverse

# All Gram products and solve-critical matvecs run at full f32 precision.
# The GPU's DEFAULT f32 matmul precision may be TF32 (10-bit mantissa),
# which loses ~3 decimal digits in X'X — unacceptable for Cholesky/inverse
# inputs and for the Boyd residuals that decide convergence.
dot = partial(jnp.dot, precision=lax.Precision.HIGHEST)


def gram(X: jnp.ndarray) -> jnp.ndarray:
    """X'X at full precision (reference: Linalg::cross_prod_lower, dsyrk)."""
    return dot(X.T, X)


def tgram(X: jnp.ndarray) -> jnp.ndarray:
    """XX' at full precision (reference: Linalg::tcross_prod_lower)."""
    return dot(X, X.T)


__all__ = [
    "power_iteration", "spectral_radius_gram", "spectral_radius_sym",
    "chol_inverse", "ridge_inverse", "dot", "gram", "tgram",
]
