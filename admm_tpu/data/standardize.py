"""glmnet-compatible data standardization and coefficient recovery.

Equivalent of the reference's ``DataStd`` class (reference:
src/DataStd.h:10-210).  The four modes are encoded exactly as the
reference does — ``flag = standardize + 2*intercept``:

  flag 0: fit directly (no centering, no scaling)
  flag 1: scale x and y by their 1/n-denominator standard deviations
  flag 2: center x, center+scale y
  flag 3: standardize x and y (center + scale)

Standard deviations use the glmnet ``1/n`` convention, NOT ``1/(n-1)``
(reference: src/DataStd.h:39-53).  ``recover`` maps coefficients fitted on
the transformed data back to the original scale and reconstructs the
intercept ``beta0 = mean(y) - sum(coef * mean(x))``
(reference: src/DataStd.h:157-207).

Everything is pure JAX: the centering/scaling fuses into one pass over X
under jit (the moral equivalent of the reference's hand-written AVX
``get_ss_avx`` / ``standardize_vec_avx`` kernels,
reference: src/Linalg/AVX.h:360-530 — here XLA does the fusion).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..linalg import dot


class StdStats(NamedTuple):
    """Centering/scaling statistics needed to undo the transform."""
    mean_x: jnp.ndarray   # (p,)
    scale_x: jnp.ndarray  # (p,)
    mean_y: jnp.ndarray   # scalar
    scale_y: jnp.ndarray  # scalar


def _sd_n(v: jnp.ndarray, axis=None) -> jnp.ndarray:
    """Standard deviation with 1/n denominator (glmnet convention).

    Centered two-pass form: the E[x^2] - E[x]^2 shortcut cancels
    catastrophically in float32 (columns with mean/sd above ~2^12 come
    out negative -> NaN), matching the reference's non-AVX path
    (reference: src/DataStd.h:39-53) rather than its AVX shortcut.
    """
    m = jnp.mean(v, axis=axis)
    c = v - (m if axis is None else jnp.expand_dims(m, axis))
    return jnp.sqrt(jnp.mean(c * c, axis=axis))


def _guard(scale: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """A (numerically) zero standard deviation must not poison the fit.

    The threshold is RELATIVE to the magnitude ``ref`` (the mean): a
    truly constant column of value c centers to +-eps*c of rounding
    noise, so its computed sd is ~eps*|c|, not 0 — an absolute sd > 0
    check standardizes that noise to a constant +-1 column whose
    recovery then divides by ~eps*|c| and fabricates huge coefficients.
    Anything with sd below 8*eps*|mean| is constant at working
    precision; leave it unscaled (the centered column is pure noise of
    magnitude eps*|c| and the penalty keeps its coefficient at 0).
    """
    floor = 8.0 * jnp.finfo(scale.dtype).eps * jnp.abs(ref)
    return jnp.where(scale > floor, scale, jnp.ones_like(scale))


def standardize(X: jnp.ndarray, y: jnp.ndarray, *, standardize_x: bool,
                intercept: bool,
                weights: jnp.ndarray = None
                ) -> Tuple[jnp.ndarray, jnp.ndarray, StdStats]:
    """Transform (X, y) per the reference's flag semantics; jit-safe.

    ``standardize_x``/``intercept`` must be Python bools (static under
    jit); the returned stats always carry well-defined values (identity
    means/scales where a mode does not use them) so downstream recovery
    code is branch-free.

    ``weights`` (extension; glmnet's ``weights`` argument): observation
    weights, normalized so they sum to n (the glmnet convention).  All
    moments become WEIGHTED moments, and the returned rows are scaled by
    ``sqrt(w)`` so the downstream unweighted least-squares machinery
    solves the weighted problem — an integer weight of k is then exactly
    equivalent to repeating the row k times (tested).  ``recover`` is
    unchanged (the stats already carry the weighted means/scales).
    """
    flag = int(standardize_x) + 2 * int(intercept)
    dtype = X.dtype
    n, p = X.shape

    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))

        def wmean(v, axis=None):
            ww = w if axis is None or v.ndim == 1 else w[:, None]
            return jnp.sum(ww * v, axis=axis) / n

        def wsd(v, axis=None):
            m = wmean(v, axis=axis)
            c = v - (m if axis is None else jnp.expand_dims(m, axis))
            ww = w if axis is None or v.ndim == 1 else w[:, None]
            return jnp.sqrt(jnp.sum(ww * c * c, axis=axis) / n)
    else:
        wmean = jnp.mean
        wsd = _sd_n

    mean_x = jnp.zeros((p,), dtype)
    scale_x = jnp.ones((p,), dtype)
    mean_y = jnp.zeros((), dtype)
    scale_y = jnp.ones((), dtype)

    if flag == 1:
        scale_y = _guard(wsd(y), wmean(y))
        y = y / scale_y
        scale_x = _guard(wsd(X, axis=0), wmean(X, axis=0))
        X = X / scale_x
    elif flag == 2:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = wmean(X, axis=0)
        X = X - mean_x
    elif flag == 3:
        my = wmean(y)
        mean_y = my
        y = y - my
        scale_y = _guard(wsd(y), my)
        y = y / scale_y
        mean_x = wmean(X, axis=0)
        scale_x = _guard(wsd(X, axis=0), mean_x)
        X = (X - mean_x) / scale_x

    if weights is not None:
        sw = jnp.sqrt(w)
        X = X * sw[:, None]
        y = y * sw

    return X, y, StdStats(mean_x, scale_x, mean_y, scale_y)


def recover(stats: StdStats, coef: jnp.ndarray, *, standardize_x: bool,
            intercept: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Map coefficients on the transformed scale back to the original.

    ``coef`` has shape (..., p) — a single vector or a whole lambda path.
    Returns ``(beta0, coef_orig)`` with ``beta0`` of shape (...,).
    Mirrors reference: src/DataStd.h:157-181.
    """
    flag = int(standardize_x) + 2 * int(intercept)
    if flag == 0:
        beta0 = jnp.zeros(coef.shape[:-1], coef.dtype)
        return beta0, coef
    if flag == 1:
        coef = coef / stats.scale_x * stats.scale_y
        beta0 = jnp.zeros(coef.shape[:-1], coef.dtype)
        return beta0, coef
    if flag == 2:
        coef = coef * stats.scale_y
        beta0 = stats.mean_y - dot(coef, stats.mean_x)
        return beta0, coef
    # flag == 3
    coef = coef / stats.scale_x * stats.scale_y
    beta0 = stats.mean_y - dot(coef, stats.mean_x)
    return beta0, coef
