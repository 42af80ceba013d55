"""Sparse inverse covariance (GRAPHICAL LASSO) by ADMM.

Extension beyond the reference (which solves penalized *regression*
only): the canonical matrix-variable ADMM application (Boyd et al. 2011
section 6.5) —

    minimize_{Theta > 0}  tr(S Theta) - logdet(Theta)
                          + lambda * ||P . Theta||_1

where ``S`` is the empirical covariance and ``P`` the penalty mask
(off-diagonals only by default, matching sklearn's ``graphical_lasso``;
``penalize_diagonal=True`` penalizes everything, matching R's
``glasso`` default).

ADMM splitting with ``A = I``, ``B = -I`` (Theta - Z = 0):

* x-update: solve ``rho Theta - Theta^{-1} = G`` with
  ``G = rho z - y - S``.  The closed form is the matrix function
  ``Theta = (G + sqrt(G^2 + 4 rho I)) / (2 rho)``; the default
  computes the square root by a coupled NEWTON-SCHULZ iteration —
  three (p, p) matmuls per step, no decomposition — more accurate in
  f32 than the eigendecomposition form; its speed-up was measured
  before the GPU port and is not yet measured on the H100
  (benchmarks/race_glasso_prox.py; DESIGN.md "glasso logdet-prox
  race"; ROADMAP A5).  ``xupdate="eigh"`` keeps the
  eigendecomposition form ``Theta = Q diag(f(w)) Q'``.  There is
  nothing to factorize once and cache, which makes this the one family
  where the reference's "fixed rho protects the factorization" rule
  (reference: src/ADMMLassoTall.h:96-97) does NOT apply: the engine
  runs the plain-ADMM ADAPTIVE rho ladder
  (reference: src/ADMMBase.h:85-109).
* z-update: masked ``soft_threshold(Theta + y/rho, lambda P / rho)`` —
  exact zeros live in Z, positive-definiteness lives in Theta.

The lambda path defaults to the warm-started ``lax.scan`` protocol,
the opposite of the regression families: each iteration is
decomposition- or matmul-dominated (not a thin matvec), so lanes add
FLOPs without adding arithmetic intensity, while warm starts cut the
iteration count ~3x.  (Chosen before the GPU port; not yet measured on
the H100, ROADMAP A5.)  ``path_mode="batch"`` stays
available (DESIGN.md "Graphical-lasso protocol").

Oracle: ``sklearn.covariance.graphical_lasso`` (coordinate-descent on
the dual) plus direct KKT certificates — tests/test_glasso.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (ADMMState, ProblemOps, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import l2norm, soft_threshold
from ..linalg import dot
from .lasso import _scan_path


class GlassoResult(NamedTuple):
    """Device-side graphical-lasso path result."""
    lambdas: jnp.ndarray    # (nlambda,) penalty grid
    precision: jnp.ndarray  # (nlambda, p, p) sparse precision matrices (Z)
    cov: jnp.ndarray        # (p, p) the empirical covariance S solved on
    niter: jnp.ndarray      # (nlambda,) int32 ADMM iteration counts
    # (nlambda, trace_len, 5) per-iteration residual trace (scan mode)
    trace: Optional[jnp.ndarray] = None


def empirical_covariance(X, weights=None, *, assume_centered=False,
                         dtype=jnp.float32):
    """Weighted MLE covariance ``sum_i w_i (x_i - mu)(x_i - mu)' / sum w``
    (the 1/n convention of sklearn's ``empirical_covariance``); integer
    weight k is exactly row repetition."""
    X = jnp.asarray(X, dtype)
    n = X.shape[0]
    w = (jnp.ones((n,), dtype) if weights is None
         else jnp.asarray(weights, dtype).ravel())
    sw = jnp.sum(w)
    if assume_centered:
        Xc = X
    else:
        mu = dot(w, X) / sw
        Xc = X - mu[None, :]
    # HIGHEST precision: S feeds a convergence test downstream
    # (default-precision f32 matmuls may run in TF32 otherwise).
    return dot((Xc * w[:, None]).T, Xc) / sw


def _logdet_prox_eigh(G, rho):
    """Eigendecomposition form of the logdet prox: solve
    ``rho Theta - Theta^{-1} = G`` via ``G = Q diag(w) Q'``."""
    w, Q = jnp.linalg.eigh(G)
    theta = (w + jnp.sqrt(w * w + 4.0 * rho)) / (2.0 * rho)
    # HIGHEST-precision reconstruction: at reduced matmul precision
    # the Boyd residuals floor at ~1e-2 and the solve never converges
    # (the solve-path rule of linalg/__init__.py).
    xn = dot(Q * theta[None, :], Q.T)
    return 0.5 * (xn + xn.T)


def _logdet_prox_newton(G, rho, max_iters=60):
    """Matmul-only logdet prox: the closed matrix-function form

        Theta = (G + sqrt(G^2 + 4 rho I)) / (2 rho)

    with the square root of ``M = G^2 + 4 rho I`` (SPD, spectrum
    >= 4 rho, so the branch is unambiguous) by the coupled
    Newton-Schulz iteration — three (p, p) matmuls per step, no
    decomposition.  ~15x MORE accurate than f32 eigh (rel. Frobenius
    error 2.5e-7 vs 3.9e-6 against an f64 reference at p=200,
    benchmarks/race_glasso_prox.py); its speed against eigh is not yet
    measured on the H100 (ROADMAP A5).  Normalization by
    ||M||_F keeps the iteration in its convergence region for ANY
    rho/G the adaptive ladder produces; the while_loop exits on a
    dtype-aware floor (quadratic terminal convergence makes the cap
    loose — typical exit is 14-22 steps).
    """
    p = G.shape[-1]
    dtype = G.dtype
    eye = jnp.eye(p, dtype=dtype)
    M = dot(G, G) + (4.0 * rho) * eye
    c = jnp.sqrt(jnp.sum(M * M))        # ||M||_F >= lambda_max(M) > 0
    A = M / c
    tol = jnp.sqrt(jnp.asarray(p, dtype)) * (
        1e-13 if dtype == jnp.float64 else 1e-6)

    def cond(carry):
        _, _, err, k = carry
        return (err > tol) & (k < max_iters)

    def body(carry):
        Y, Z, _, k = carry
        W = dot(Z, Y)
        T = 0.5 * (3.0 * eye - W)
        err = jnp.sqrt(jnp.sum((W - eye) ** 2))
        return dot(Y, T), dot(T, Z), err, k + 1

    Y, _, _, _ = jax.lax.while_loop(
        cond, body, (A, eye, jnp.asarray(jnp.inf, dtype),
                     jnp.int32(0)))
    xn = (G + jnp.sqrt(c) * Y) / (2.0 * rho)
    return 0.5 * (xn + xn.T)


def _glasso_ops(S, pen_mask, p, xupdate="newton") -> ProblemOps:
    prox = (_logdet_prox_newton if xupdate == "newton"
            else _logdet_prox_eigh)

    def next_x(st):
        G = st.rho * st.z - st.y - S
        G = 0.5 * (G + G.T)
        return prox(G, st.rho)

    def next_z(st, x_new):
        v = x_new + st.y / st.rho
        return soft_threshold(v, (st.lam / st.rho) * pen_mask), None

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.x),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p * p, dim_dual=p * p,
    )


def _glasso_engine(S, pen_mask, lam_first, rho0, xupdate="newton"):
    p = S.shape[-1]
    dtype = S.dtype
    ops = _glasso_ops(S, pen_mask, p, xupdate)
    solve = make_admm_solver(ops, adapt_rho=True)
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.asarray(1.0, dtype))
    Z = jnp.zeros((p, p), dtype)
    st0 = make_state(Z, Z, Z, rho, lam_first, dtype=dtype)
    # Report Z: exact zeros (the support) live in the soft-thresholded
    # iterate; Theta (= x) is its PD twin within solver tolerance.
    return st0, solve, (lambda st: st.z)


def _glasso_batch_states(k, p, rho, lams, dtype):
    Z = jnp.zeros((k, p, p), dtype)
    ones = jnp.ones((k,), dtype)
    return ADMMState(
        x=Z, z=Z, y=Z, adj_z=Z, adj_y=Z, aux=None,
        adj_a=ones, adj_c=9999.0 * ones,
        rho=rho * ones, lam=jnp.asarray(lams, dtype),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=jnp.zeros((k,), jnp.int32),
        done=jnp.zeros((k,), bool),
    )


def _solve_glasso(S, pen_mask, lams, rho0, maxit, eps_abs, eps_rel,
                  path_mode, trace_len=None, xupdate="newton"):
    p = S.shape[-1]
    dtype = S.dtype
    if path_mode == "batch":
        ops = _glasso_ops(S, pen_mask, p, xupdate)
        solve = make_batched_solver(make_admm_solver(ops, adapt_rho=True))
        rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                        jnp.asarray(1.0, dtype))
        st = _glasso_batch_states(lams.shape[0], p, rho, lams, dtype)
        st = solve(st, maxit, eps_abs, eps_rel)
        return st.z, st.it, None
    st0, solve, report = _glasso_engine(S, pen_mask, lams[0], rho0,
                                        xupdate)
    _, precs, niter, traces = _scan_path(st0, solve, report, lams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return precs, niter, traces


@partial(jax.jit, static_argnames=("nlambda", "penalize_diagonal",
                                   "path_mode", "trace_len", "xupdate"))
def _glasso_path_dev(S, nlambda, lambda_min_ratio, user_lams, rho0,
                     maxit, eps_abs, eps_rel, *, penalize_diagonal,
                     path_mode, trace_len=None, xupdate="newton"):
    p = S.shape[-1]
    dtype = S.dtype
    eye = jnp.eye(p, dtype=dtype)
    pen_mask = jnp.ones((p, p), dtype) if penalize_diagonal else 1.0 - eye
    if user_lams is None:
        # Grid top: for lambda >= max|offdiag(S)| the KKT system is
        # satisfied by a DIAGONAL precision (soft-thresholding kills
        # every off-diagonal of S), so the path starts exactly at the
        # empty graph — the glasso analog of ||X'y||_inf / n.  A
        # DIAGONAL S makes that threshold 0 (log(0) would NaN the whole
        # grid): fall back to the diagonal scale — the path is constant
        # there, but finite (the conlasso/genlasso guard pattern).
        lam0 = jnp.max(jnp.abs(S * (1.0 - eye)))
        lam0_fb = jnp.maximum(jnp.max(jnp.abs(S)),
                              jnp.asarray(1.0, dtype))
        lam0 = jnp.where(jnp.isfinite(lam0) & (lam0 > 0), lam0, lam0_fb)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams
    precs, niter, traces = _solve_glasso(S, pen_mask, lams, rho0, maxit,
                                         eps_abs, eps_rel, path_mode,
                                         trace_len, xupdate)
    return GlassoResult(lambdas=lams, precision=precs, cov=S,
                        niter=niter, trace=traces)


def glasso_path(X=None, *, cov=None, weights=None,
                lambdas: Optional[jnp.ndarray] = None, nlambda: int = 20,
                lambda_min_ratio: float = 1e-2,
                penalize_diagonal: bool = False,
                assume_centered: bool = False, maxit: int = 10000,
                eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                rho: float = -1.0, path_mode: str = "scan",
                xupdate: str = "newton",
                trace_len: Optional[int] = None, data_mesh=None,
                dtype=jnp.float32) -> GlassoResult:
    """Solve the graphical-lasso lambda path on device.

    Pass the (n, p) data matrix ``X`` (the empirical covariance is
    computed on device, weighted by ``weights``) or a precomputed
    (p, p) covariance via ``cov=`` (sklearn's ``graphical_lasso(emp_cov,
    alpha)`` convention — ``lambdas`` are on the same scale as sklearn's
    ``alpha``).  The auto grid runs from the exact empty-graph threshold
    ``max|offdiag(S)|`` down by ``lambda_min_ratio``.  ``path_mode`` /
    ``trace_len`` as in the Lasso path (tracing implies scan).

    ``xupdate`` picks the logdet-prox implementation: ``"newton"``
    (default — matmul-only Newton-Schulz square root, more accurate
    than f32 eigh; chosen for speed before the GPU port, not yet
    measured on the H100) or
    ``"eigh"`` (the eigendecomposition form, kept for verification and
    for extreme ill-conditioning: the Newton form's f32 floor is
    ``u * kappa(G^2 + 4 rho I)``, see ``_logdet_prox_newton``).
    """
    if (X is None) == (cov is None):
        raise ValueError("pass exactly one of X or cov")
    if cov is not None:
        S = jnp.asarray(cov, dtype)
        if S.ndim != 2 or S.shape[0] != S.shape[1]:
            raise ValueError("cov must be a square (p, p) matrix")
        if weights is not None:
            raise ValueError("weights apply to X, not a precomputed cov")
    else:
        if data_mesh is not None:
            # Operator parallelism for the covariance build (the only
            # n-bound step; iterations are (p, p)-bound): row-shard X,
            # XLA turns the moment products into per-shard partials +
            # all-reduce (lasso_path(data_mesh=) pattern).
            from ..parallel.mesh import put_dim_sharded

            X = put_dim_sharded(jnp.asarray(X, dtype), data_mesh, 0)
            if weights is not None:
                weights = put_dim_sharded(
                    jnp.asarray(weights, dtype).ravel(), data_mesh, 0)
        S = empirical_covariance(X, weights, dtype=dtype,
                                 assume_centered=assume_centered)
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if xupdate not in ("newton", "eigh"):
        raise ValueError("xupdate must be 'newton' or 'eigh'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else jnp.sort(jnp.atleast_1d(
                jnp.asarray(lambdas, dtype)))[::-1])
    return _glasso_path_dev(S, int(nlambda), lambda_min_ratio, lams,
                            rho, maxit, eps_abs, eps_rel,
                            penalize_diagonal=bool(penalize_diagonal),
                            path_mode=path_mode, trace_len=trace_len,
                            xupdate=xupdate)


# ---------------------------------------------------------------------
# Cross-validation: held-out Gaussian log-likelihood, one-pass protocol.
# ---------------------------------------------------------------------

class CVGlassoResult(NamedTuple):
    lambdas: np.ndarray   # (nlambda,) shared grid
    cvm: np.ndarray       # (nlambda,) mean held-out negative log-lik
    cvsd: np.ndarray      # (nlambda,) its standard error
    lambda_min: float     # grid point minimising cvm
    lambda_1se: float     # largest lambda with cvm <= min + 1 se
    fit: GlassoResult     # full-data path on the same grid
    foldid: np.ndarray    # (n,) fold assignment


def _fold_cov(X, w):
    """Weighted empirical covariance and mean for one fold lane."""
    sw = jnp.sum(w)
    mu = dot(w, X) / sw
    Xc = X - mu[None, :]
    return dot((Xc * w[:, None]).T, Xc) / sw, mu


@partial(jax.jit, static_argnames=("penalize_diagonal", "xupdate"))
def _cv_glasso_core(X, masks, w, lams, rho0, maxit, eps_abs, eps_rel,
                    *, penalize_diagonal, xupdate="newton"):
    """The whole fold sweep as ONE compiled program (cv.py onepass
    protocol): fold f's training covariance is the weighted covariance
    with weight 0 on held-out rows, all folds' paths solve as vmapped
    lanes, and held-out scoring stays on device.

    Returns ``(quad (n, L), logdet (nfolds, L))`` where ``quad[i, l]``
    is row i's Mahalanobis term under the fold fit that EXCLUDED it
    (centered by that fold's training mean) and ``logdet[f, l]`` is
    the fold's log-determinant — the two pieces of the per-observation
    Gaussian negative log-likelihood."""
    p = X.shape[1]
    dtype = X.dtype
    eye = jnp.eye(p, dtype=dtype)
    pen_mask = (jnp.ones((p, p), dtype) if penalize_diagonal
                else 1.0 - eye)

    def fold_fit(mask):
        S_f, mu_f = _fold_cov(X, w * mask)
        # Scan protocol inside the fold vmap (the measured glasso
        # default): folds advance their warm-started paths in lockstep.
        precs, _, _ = _solve_glasso(S_f, pen_mask, lams, rho0, maxit,
                                    eps_abs, eps_rel, "scan",
                                    xupdate=xupdate)
        return precs, mu_f

    precs, mus = jax.vmap(fold_fit)(masks)      # (F, L, p, p), (F, p)

    def fold_score(prec_f, mu_f, mask):
        Xc = X - mu_f[None, :]
        # (L, n) per-row quadratic form under every path point.
        quad = jnp.einsum("np,lpq,nq->ln", Xc, prec_f, Xc,
                          precision=jax.lax.Precision.HIGHEST)
        # Select this fold's own held-out rows on device.
        return quad * (1.0 - mask)[None, :]

    quads = jax.vmap(fold_score)(precs, mus, masks)   # (F, L, n)
    quad = jnp.sum(quads, axis=0).T                   # (n, L)
    sign, logdet = jnp.linalg.slogdet(precs)          # (F, L)
    logdet = jnp.where(sign > 0, logdet, -jnp.inf)
    return quad, logdet


def cv_glasso_path(X, *, nfolds: int = 10, foldid=None, weights=None,
                   lambdas: Optional[jnp.ndarray] = None,
                   nlambda: int = 20, lambda_min_ratio: float = 1e-2,
                   penalize_diagonal: bool = False, maxit: int = 10000,
                   eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                   rho: float = -1.0, xupdate: str = "newton",
                   seed: int = 0, fold_mesh=None,
                   dtype=jnp.float32) -> CVGlassoResult:
    """K-fold CV for the graphical lasso (sklearn's ``GraphicalLassoCV``
    analog), scored by the held-out Gaussian negative log-likelihood
    ``(x - mu)' Theta (x - mu) - logdet Theta`` per observation (the
    Gaussian deviance up to constants; test rows are centered by the
    TRAINING fold's mean).  The grid is computed once on the full data;
    the whole fold sweep runs as one compiled program (``cv_mode
    onepass``); cvm/cvsd follow glmnet's per-observation aggregation.
    """
    Xd = jnp.asarray(X, dtype)
    n, p = Xd.shape
    if foldid is not None:
        foldid = np.asarray(foldid, int)
        if foldid.shape != (n,):
            raise ValueError("foldid must have one entry per row")
        nfolds = int(foldid.max()) + 1
        counts = np.bincount(foldid[foldid >= 0], minlength=nfolds)
        if nfolds < 2 or np.any(counts == 0):
            raise ValueError(
                "foldid must assign at least one row to each of >= 2 "
                f"folds (got counts {counts.tolist()})")
    else:
        nfolds = int(nfolds)
        if not 2 <= nfolds <= n:
            raise ValueError("nfolds must be in [2, nrow(x)]")
        rng = np.random.default_rng(seed)
        foldid = np.tile(np.arange(nfolds), n // nfolds + 1)[:n]
        foldid = foldid[rng.permutation(n)]
    w = (jnp.ones((n,), dtype) if weights is None
         else jnp.asarray(weights, dtype).ravel())

    fit = glasso_path(X, weights=weights, lambdas=lambdas,
                      nlambda=nlambda,
                      lambda_min_ratio=lambda_min_ratio,
                      penalize_diagonal=penalize_diagonal, maxit=maxit,
                      eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                      xupdate=xupdate, dtype=dtype)
    lams = fit.lambdas

    masks = jnp.asarray(
        foldid[None, :] != np.arange(nfolds)[:, None], dtype)
    if fold_mesh is not None:
        # Folds are independent: shard the fold-mask axis over the mesh
        # and the vmapped sweep partitions one fold path per device
        # (the cv.py fold_mesh pattern).
        from ..models.cv import _shard_folds

        masks = _shard_folds(masks, fold_mesh)
    quad, logdet = _cv_glasso_core(
        Xd, masks, w, lams, jnp.asarray(rho, dtype), maxit, eps_abs,
        eps_rel, penalize_diagonal=bool(penalize_diagonal),
        xupdate=xupdate)
    quad = np.asarray(quad)          # (n, L)
    logdet = np.asarray(logdet)      # (F, L)

    # Per-observation negative log-likelihood (constants dropped).
    # foldid < 0 rows (the cv.py 'train-always' convention) are never
    # held out: exclude them from scoring — numpy's logdet[-1] would
    # otherwise wrap to the LAST fold and add a garbage row to cvm.
    scored = foldid >= 0
    cvraw = (quad - logdet[np.clip(foldid, 0, None)])[scored]
    ws = np.asarray(w)[scored]
    ws = ws / ws.sum()
    nsc = int(scored.sum())
    cvm = ws @ cvraw
    cvsd = np.sqrt((ws @ (cvraw - cvm) ** 2) / max(nsc - 1, 1))
    imin = int(np.argmin(cvm))
    lam_np = np.asarray(lams)
    ok = cvm <= cvm[imin] + cvsd[imin]
    lambda_min = float(lam_np[imin])
    lambda_1se = float(lam_np[np.flatnonzero(ok)[0]])
    return CVGlassoResult(lambdas=lam_np, cvm=cvm, cvsd=cvsd,
                          lambda_min=lambda_min, lambda_1se=lambda_1se,
                          fit=fit, foldid=foldid)


def partial_correlations(precision):
    """Partial-correlation matrix from a precision matrix (or a
    (k, p, p) path of them): ``P_ij = -Theta_ij / sqrt(Theta_ii
    Theta_jj)`` with unit diagonal — the scale-free edge weights of
    the Gaussian graphical model."""
    T = jnp.asarray(precision)
    d = jnp.sqrt(jnp.abs(jnp.diagonal(T, axis1=-2, axis2=-1)))
    P = -T / (d[..., :, None] * d[..., None, :])
    eye = jnp.eye(T.shape[-1], dtype=T.dtype)
    return P * (1.0 - eye) + eye
