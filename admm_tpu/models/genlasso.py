"""Generalized Lasso: ``minimize 1/(2n)||y - X b||^2 + lambda ||D b||_1``.

Extension beyond the reference (which penalizes only ``||b||_1``): an
arbitrary penalty matrix ``D`` covers the FUSED LASSO (D = first
differences: piecewise-constant signals), TREND FILTERING (higher-order
differences: piecewise-polynomial fits), sparse fused lasso (stacked
[I; D]) and graph-structured penalties — the classic ADMM showcase
(Boyd et al. 2011 section 6.4, Tibshirani & Taylor 2011).

ADMM splitting with ``A = D``, ``B = -I``::

    minimize f(b) + g(z)   s.t.  D b - z = 0
    f = 1/2||y - X b||^2,  g = lambda ||z||_1

* x-update: cached SPD solve ``(X'X + rho D'D) b = X'y - D'adj_y
  + rho D'adj_z`` — the same one-time-explicit-inverse pattern as the
  tall Lasso (reference: src/ADMMLassoTall.h:70-80), so each iteration
  is a p x p matvec plus two thin D products;
* z-update: ``soft_threshold(D b + adj_y/rho, lambda/rho)``;
* accelerated FADMM engine with fixed rho (the factorization is
  rho-dependent, exactly the reference's reason for pinning rho,
  reference: src/ADMMLassoTall.h:96-97).

The whole lambda path runs as batched lanes (batch mode) or warm-started
scan, sharing the engines and tracing of the Lasso path.

Standardization note: ``D`` encodes structure in the ORIGINAL
coordinates, and rescaling columns silently changes the model
``||D b||_1`` describes — so there is no ``standardize`` option here;
``intercept=True`` mean-centers X and y (centering does not rescale
coordinates, so D's meaning is preserved) and reconstructs
``b0 = mean(y) - sum(b mean(x))``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (make_batched_solver, make_fadmm_solver,
                           make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import chol_inverse, dot, gram
from .lasso import PathResult, _batched_cold_states, _scan_path


def difference_matrix(p: int, order: int = 1) -> np.ndarray:
    """The (p - order, p) discrete difference operator of the given
    order: order 1 = fused lasso (penalizes |b_{i+1} - b_i|), order 2 =
    linear trend filtering, etc."""
    D = np.eye(p)
    for _ in range(order):
        D = D[1:] - D[:-1]
    return D


def difference_matrix_2d(shape) -> np.ndarray:
    """The anisotropic 2-D total-variation operator for a grid of
    ``shape = (rows, cols)`` variables (row-major flattened): stacks
    all horizontal and vertical first differences — ``gen_lasso_path``
    with this D is TV-regularized image reconstruction (piecewise-
    constant in both directions)."""
    r, c = shape
    eye = np.eye(r * c)
    rows = []
    for i in range(r):
        for j in range(c - 1):
            rows.append(eye[i * c + j + 1] - eye[i * c + j])
    for i in range(r - 1):
        for j in range(c):
            rows.append(eye[(i + 1) * c + j] - eye[i * c + j])
    return np.asarray(rows)


def center_weight(X, y, weights, intercept):
    """Weighted mean-centering + sqrt(w) row scaling for the
    original-coordinate families (generalized/constrained Lasso):
    their penalty/constraint matrices encode structure in the ORIGINAL
    coordinates, so columns are centered (meaning-preserving) but never
    rescaled.  Returns ``(Xs, ys, mean_x, mean_y)`` with weights
    normalized to sum n (glmnet convention) and folded into the rows —
    downstream unweighted quadratic machinery becomes the weighted
    loss."""
    n, p = X.shape
    dtype = X.dtype
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))
    wmean = (jnp.mean if w is None
             else lambda v, axis=None: (
                 jnp.sum((w if v.ndim == 1 else w[:, None]) * v,
                         axis=axis) / n))
    if intercept:
        mean_x = wmean(X, axis=0)
        mean_y = wmean(y)
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    else:
        Xs, ys = X, y
        mean_x = jnp.zeros((p,), dtype)
        mean_y = jnp.asarray(0.0, dtype)
    if w is not None:
        sw = jnp.sqrt(w)
        Xs = Xs * sw[:, None]
        ys = ys * sw
    return Xs, ys, mean_x, mean_y


def _genlasso_ops(D, Minv, Xty):
    m, p = D.shape

    def next_x(st):
        rhs = Xty + dot(D.T, st.rho * st.adj_z - st.adj_y)
        return dot(Minv, rhs)

    def next_z(st, x_new):
        Dx = dot(D, x_new)
        v = Dx + st.adj_y / st.rho
        return soft_threshold(v, st.lam / st.rho), Dx

    from ..core.engine import ProblemOps

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        # aux carries the cached D x of the fresh iterate.
        primal_residual=lambda st, x, z, aux: aux - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.aux),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(dot(D.T, st.y)),
        dual_residual=lambda st, z_new: st.rho * l2norm(
            dot(D.T, z_new - st.z)),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=m,
    )


def _genlasso_setup(Xs, ys, D, lam_first, rho0):
    dtype = Xs.dtype
    p = Xs.shape[1]
    Xty = dot(Xs.T, ys)
    XtX = gram(Xs)
    DtD = gram(D)
    # Auto-rho: balance the data term against the penalty coupling —
    # the tall-Lasso power law on the joint operator scale
    # (reference analog: src/ADMMLassoTall.h:194-202).
    from ..linalg import spectral_radius_sym

    sprad = spectral_radius_sym(XtX)
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.cbrt(sprad) * lam_first ** (2.0 / 3.0))
    # Jitter guards rank deficiency of X'X + rho D'D (e.g. X with p > n
    # and D with a nontrivial null space).
    M = XtX + rho * DtD
    Minv = chol_inverse(M, jitter=1e-6 if dtype == jnp.float32 else 0.0)
    return Minv, Xty, rho


def _genlasso_engine(Xs, ys, D, lam_first, rho0):
    n, p = Xs.shape
    dtype = Xs.dtype
    m = D.shape[0]
    Minv, Xty, rho = _genlasso_setup(Xs, ys, D, lam_first, rho0)
    ops = _genlasso_ops(D, Minv, Xty)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    zp = jnp.zeros((p,), dtype)
    zm = jnp.zeros((m,), dtype)
    st0 = make_state(zp, zm, zm, rho, lam_first, aux=zm, dtype=dtype)
    return st0, solve, (lambda st: st.x)


def _solve_genlasso_scan(Xs, ys, D, ilams, rho0, maxit, eps_abs, eps_rel,
                         trace_len=None):
    st0, solve, report = _genlasso_engine(Xs, ys, D, ilams[0], rho0)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                         maxit, eps_abs, eps_rel,
                                         trace_len)
    return coefs, niter, traces


def _solve_genlasso_batch(Xs, ys, D, ilams, rho0, maxit, eps_abs,
                          eps_rel):
    n, p = Xs.shape
    m = D.shape[0]
    dtype = Xs.dtype
    Minv, Xty, rho = _genlasso_setup(Xs, ys, D, ilams[0], rho0)
    ops = _genlasso_ops(D, Minv, Xty)
    solve = make_batched_solver(make_fadmm_solver(ops, adapt_rho=False))
    k = ilams.shape[0]
    st = _batched_cold_states(k, p, rho, ilams, dtype, aux_dim=m)
    st = st._replace(z=jnp.zeros((k, m), dtype),
                     y=jnp.zeros((k, m), dtype),
                     adj_z=jnp.zeros((k, m), dtype),
                     adj_y=jnp.zeros((k, m), dtype))
    st = solve(st, maxit, eps_abs, eps_rel)
    return st.x, st.it, None


@partial(jax.jit, static_argnames=("intercept", "nlambda", "path_mode",
                                   "trace_len"))
def _gen_path(X, y, D, nlambda, lambda_min_ratio, user_lams, rho, maxit,
              eps_abs, eps_rel, weights=None, *, intercept, path_mode,
              trace_len=None):
    n, p = X.shape
    dtype = X.dtype
    Xs, ys, mean_x, mean_y = center_weight(X, y, weights, intercept)

    if user_lams is None:
        # Grid top: beta = 0 is optimal iff X'y = D'v for some
        # ||v||_inf <= lambda; the least-squares v is a certificate, so
        # ||v_ls||_inf upper-bounds the interesting range (exact when
        # D = I; the standard genlasso heuristic otherwise).  DD' is
        # SINGULAR whenever D has linearly dependent rows (m > p, e.g.
        # the stacked [I; D] sparse fused lasso), so the solve is always
        # regularized with a RELATIVE jitter — under f64 a zero jitter
        # silently produced an all-NaN grid (advisor finding r2) — and
        # a non-finite/degenerate lam0 falls back to the D = I bound
        # max|X'y|/n (a valid upper bound up to ||D||, and only the grid
        # TOP of a heuristic certificate).
        DDt = gram(D.T)
        v_ls = dot(chol_inverse(
            DDt, jitter=1e-6 if dtype == jnp.float32 else 1e-12),
            dot(D, dot(Xs.T, ys)))
        lam0 = jnp.max(jnp.abs(v_ls)) / n
        lam0_fb = jnp.max(jnp.abs(dot(Xs.T, ys))) / n
        lam0 = jnp.where(jnp.isfinite(lam0) & (lam0 > 0), lam0, lam0_fb)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams
    ilams = lams * n

    if path_mode == "batch":
        coefs, niter, traces = _solve_genlasso_batch(
            Xs, ys, D, ilams, rho, maxit, eps_abs, eps_rel)
    else:
        coefs, niter, traces = _solve_genlasso_scan(
            Xs, ys, D, ilams, rho, maxit, eps_abs, eps_rel, trace_len)
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs, niter=niter,
                      trace=traces)


def gen_lasso_path(X, y, D, *, lambdas: Optional[jnp.ndarray] = None,
                   nlambda: int = 50,
                   lambda_min_ratio: float = 1e-3,
                   intercept: bool = True, maxit: int = 10000,
                   eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                   rho: float = -1.0, path_mode: str = "batch",
                   trace_len: Optional[int] = None,
                   weights: Optional[jnp.ndarray] = None,
                   data_mesh=None,
                   dtype=jnp.float32) -> PathResult:
    """Solve the generalized-Lasso lambda path on device.

    ``D`` is the (m, p) penalty matrix (:func:`difference_matrix` builds
    the fused-lasso / trend-filtering operators).  ``D = I`` reduces
    exactly to :func:`admm_tpu.models.lasso.lasso_path` with
    ``standardize=False`` (tested).  ``weights`` (extension — glmnet's
    ``weights`` argument): observation weights on the quadratic loss
    (integer weight k == repeating the row k times, tested); the
    D-penalty is unaffected.  ``path_mode`` / ``trace_len`` as in the
    Lasso path (tracing implies the scan protocol).
    """
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    if data_mesh is not None:
        # Operator parallelism: row-shard the data; the (p, p) / D-side
        # solve state stays replicated (lasso_path(data_mesh=) pattern).
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        y = put_dim_sharded(y, data_mesh, 0)
    D = jnp.asarray(D, dtype)
    if D.ndim != 2 or D.shape[1] != X.shape[1]:
        raise ValueError("D must be (m, ncol(x))")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else jnp.sort(jnp.asarray(lambdas, dtype))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    return _gen_path(X, y, D, int(nlambda), lambda_min_ratio, lams, rho,
                     maxit, eps_abs, eps_rel, w, intercept=intercept,
                     path_mode=path_mode, trace_len=trace_len)


def fused_lasso_path(X, y, *, order: int = 1, **kw) -> PathResult:
    """Fused lasso / trend filtering: the generalized Lasso with the
    discrete difference operator of the given order."""
    p = np.asarray(X).shape[1]
    return gen_lasso_path(X, y, difference_matrix(p, order), **kw)
