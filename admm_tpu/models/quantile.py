"""l1-penalized QUANTILE regression paths.

Extension beyond the reference: the penalized check-loss model

    minimize_b0,b  (1/n) sum_i w_i rho_tau(y_i - b0 - x_i'b)
                   + lam ||b||_1,
    rho_tau(r) = tau max(r, 0) + (1 - tau) max(-r, 0)

— the lambda-path completion of :func:`admm_tpu.models.lad.quantile_fit`
(which generalizes the reference's LAD z-prox,
reference: src/ADMMLAD.h:94-98, to asymmetric tau), exactly as the
Elastic Net completes the Lasso.

ADMM splitting: the sqrt-lasso's STACKED form (both nonsmooth terms
prox-friendly; models/sqrtlasso.py::_stacked_ops)::

    A = [-X; I],  z = [r; w],  c = [-y; 0]
    f(b) = 0,  g(z) = sum_i w_i rho_tau(r_i) + ilam sum_j pf_j |w_j|

x-update: one cached ``(X'X + I)^{-1}`` matvec per iteration (the
reference's cached-solve pattern, reference: src/ADMMLassoTall.h:70-80);
r-prox: the elementwise ASYMMETRIC soft threshold (the check-loss prox,
models/lad.py::_asym_soft_threshold) with per-row weight scaling;
w-prox: soft threshold with penalty factor 0 on the free intercept
column — the intercept is optimized UNDER the check loss (the
quantile-optimal intercept is a quantile, not a mean; the same
deliberate fix as lad_fit).  Accelerated FADMM at fixed rho.

tau rides ``state.aux`` (a per-lane scalar), so a tau grid and a
lambda grid batch together as (T x L) batched lanes in one while_loop.

Internal scale: ``ilam = n lam / scale_y`` with the penalty on the
STANDARDIZED coefficients (the glmnet convention; with
``standardize=False`` the objective above is literal, which is how the
sklearn ``QuantileRegressor`` oracle is pinned —
tests/test_quantile.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.engine import (ADMMState, make_batched_solver,
                           make_fadmm_solver, make_state,
                           make_traced_solve)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..data.standardize import _guard
from ..linalg import chol_inverse, dot, gram
from .lad import _asym_soft_threshold
from .sqrtlasso import _stacked_ops


class QuantilePathResult(NamedTuple):
    """tau x lambda grid of penalized quantile fits."""
    taus: jnp.ndarray      # (T,)
    lambdas: jnp.ndarray   # (T, L) per-tau grids, decreasing in L
    beta0: jnp.ndarray     # (T, L)
    coef: jnp.ndarray      # (T, L, p)
    niter: jnp.ndarray     # (T, L) int32
    # (T, L, trace_len, 5) per-iteration residual buffers when tracing
    # was requested (admm_tpu.diag.trace conventions).
    trace: Optional[jnp.ndarray] = None


def _quantile_prepare(X, y, weights, *, standardize_x, intercept):
    """Weighted center/scale WITHOUT sqrt(w) row scaling: the check
    loss is 1-homogeneous, so weights enter the r-prox thresholds
    directly (w_i rho_tau(r_i) != rho_tau(sqrt(w_i) r_i)) rather than
    as row scaling (which is exact only for quadratic losses)."""
    n, p = X.shape
    dtype = X.dtype
    w = jnp.ones((n,), dtype)
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))

    def wmean(v, axis=None):
        ww = w if v.ndim == 1 else w[:, None]
        return jnp.sum(ww * v, axis=axis) / n

    mean_x = jnp.zeros((p,), dtype)
    mean_y = jnp.asarray(0.0, dtype)
    sd_x = jnp.ones((p,), dtype)
    sd_y = jnp.asarray(1.0, dtype)
    Xs, ys = X, y
    if intercept:
        mean_x = wmean(X, axis=0)
        mean_y = wmean(y)
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    if standardize_x:
        cx = X - wmean(X, axis=0)[None, :]
        sd_x = _guard(jnp.sqrt(jnp.sum(w[:, None] * cx * cx, axis=0)
                               / n), wmean(X, axis=0))
        Xs = Xs / sd_x[None, :]
        cy = y - wmean(y)
        sd_y = _guard(jnp.sqrt(jnp.sum(w * cy * cy) / n)[None],
                      wmean(y)[None])[0]
        ys = ys / sd_y
    return Xs, ys, w, sd_x, sd_y, mean_x, mean_y


def _quantile_ops(Xa, ys, Minv, w, pf, n, q):
    """Stacked ops with the weighted check-loss r-prox.  ``state.aux``
    is the pytree ``(tau, Ax_cache)``: tau is a per-lane scalar (so a
    tau grid vmaps as lanes), Ax the stacked ops' cached ``A x`` (one
    matvec per iteration, not three)."""
    def prox_r(st, vr):
        tau = st.aux[0]
        return _asym_soft_threshold(vr, w * tau / st.rho,
                                    w * (1.0 - tau) / st.rho)

    def prox_w(st, vw):
        return soft_threshold(vw, (st.lam / st.rho) * pf)

    ops = _stacked_ops(Xa, ys, Minv, n, q, prox_r, prox_w)

    def next_z(st, x_new):
        z_new, ax = ops.next_z(st, x_new)
        return z_new, (st.aux[0], ax)

    def primal_residual(st, x, z, aux):
        return jnp.concatenate([ys - aux[1] - z[:n], x - z[n:]])

    def eps_primal_scale(st):
        ax = jnp.sqrt(sqnorm(st.aux[1]) + sqnorm(st.x))
        return jnp.maximum(jnp.maximum(ax, l2norm(st.z)), l2norm(ys))

    return ops._replace(next_z=next_z, primal_residual=primal_residual,
                        eps_primal_scale=eps_primal_scale)


def _quantile_setup(Xs, ys, intercept, rho0):
    """Cached inverse + free-intercept augmentation + penalty factors."""
    n, p = Xs.shape
    dtype = Xs.dtype
    if intercept:
        Xa = jnp.concatenate([jnp.ones((n, 1), dtype), Xs], axis=1)
        pf = jnp.concatenate([jnp.zeros((1,), dtype),
                              jnp.ones((p,), dtype)])
    else:
        Xa = Xs
        pf = jnp.ones((p,), dtype)
    q = Xa.shape[1]
    jit = 1e-7 if dtype == jnp.float32 else 0.0
    Minv = chol_inverse(gram(Xa) + jnp.eye(q, dtype=dtype), jitter=jit)
    # Fixed-rho FADMM; rho = 10, measured (DESIGN.md "quantile rho"):
    # 1.5-2x fewer iterations than rho = 1 at unchanged oracle
    # accuracy across three shapes; rho >= 30 triggers FALSE
    # convergence (the check loss's flat pieces let the Boyd residuals
    # pass far from the optimum when the dual scale blows up) — do not
    # raise this without re-running the accuracy-checked sweep.
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.asarray(10.0, dtype))
    return Xa, pf, q, Minv, rho


def _quantile_lam0(Xs, ys, w, tau, n, intercept):
    """Exact-up-to-ties null threshold: with b = 0 the optimal free
    intercept is the weighted tau-quantile a* (0 without an
    intercept); b = 0 stays optimal iff ilam >= max_j |sum_i x_ij g_i|
    with g the check-loss subgradient.  Rows AT the quantile have
    subgradient freedom in [-(1-tau), tau] — bounded by
    max(tau, 1-tau) — so the tie term makes the returned value a safe
    upper bound (a too-high grid top only adds one all-zero path
    point)."""
    if intercept:
        # Weighted tau-quantile via the sorted-cumulative-weight rule.
        order = jnp.argsort(ys)
        cw = jnp.cumsum(w[order])
        k = jnp.searchsorted(cw, tau * cw[-1])
        a = ys[order][jnp.minimum(k, n - 1)]
    else:
        a = jnp.asarray(0.0, ys.dtype)
    r = ys - a
    g = w * jnp.where(r > 0, tau, jnp.where(r < 0, -(1.0 - tau), 0.0))
    tie = w * (r == 0) * jnp.maximum(tau, 1.0 - tau)
    return jnp.max(jnp.abs(dot(Xs.T, g)) + dot(jnp.abs(Xs.T), tie))


def _cold_lanes(k, q, n, rho, ilams, taus, dtype):
    zeros = jnp.zeros((k, q), dtype)
    znq = jnp.zeros((k, n + q), dtype)
    ones = jnp.ones((k,), dtype)
    return ADMMState(
        x=zeros, z=znq, y=znq, adj_z=znq, adj_y=znq, aux=taus,
        adj_a=ones, adj_c=9999.0 * ones,
        rho=rho * ones, lam=jnp.asarray(ilams, dtype),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=jnp.zeros((k,), jnp.int32),
        done=jnp.zeros((k,), bool),
    )


@partial(jax.jit, static_argnames=("nlambda", "standardize_x",
                                   "intercept", "path_mode",
                                   "trace_len"))
def _quantile_path_dev(X, y, taus, nlambda, lambda_min_ratio, user_lams,
                       rho0, maxit, eps_abs, eps_rel, weights=None, *,
                       standardize_x, intercept, path_mode,
                       trace_len=None):
    n, p = X.shape
    dtype = X.dtype
    Xs, ys, w, sd_x, sd_y, mean_x, mean_y = _quantile_prepare(
        X, y, weights, standardize_x=standardize_x, intercept=intercept)
    Xa, pf, q, Minv, rho = _quantile_setup(Xs, ys, intercept, rho0)
    T = taus.shape[0]

    if user_lams is None:
        # Per-tau grids from each tau's own null threshold.
        Xslope = Xa[:, 1:] if intercept else Xa
        lam0s = jax.vmap(
            lambda t: _quantile_lam0(Xslope, ys, w, t, n, intercept)
        )(taus) * sd_y / n * (1.0 + 1e-4)
        lams = jnp.exp(jax.vmap(lambda l0: jnp.linspace(
            jnp.log(l0), jnp.log(lambda_min_ratio * l0), nlambda))(lam0s))
    elif user_lams.ndim == 2:
        lams = user_lams          # per-tau grids (the CV fold sweep)
    else:
        lams = jnp.broadcast_to(user_lams[None, :], (T,) +
                                user_lams.shape)
    L = lams.shape[1]
    ilams = lams * n / sd_y

    ops = _quantile_ops(Xa, ys, Minv, w, pf, n, q)
    traces = None
    if path_mode == "batch":
        solve = make_batched_solver(make_fadmm_solver(ops,
                                                      adapt_rho=False))
        st = _cold_lanes(T * L, q, n, rho, ilams.ravel(),
                         jnp.repeat(taus, L), dtype)
        st = st._replace(aux=(st.aux, jnp.zeros((T * L, n), dtype)))
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs = st.z[:, n:].reshape(T, L, q)
        niter = st.it.reshape(T, L)
    else:
        solve = make_fadmm_solver(ops, adapt_rho=False)
        solve_t = (None if trace_len is None
                   else make_traced_solve(solve, trace_len))

        def one_tau(tau, ilam_row):
            znq = jnp.zeros((n + q,), dtype)
            st0 = make_state(jnp.zeros((q,), dtype), znq, znq, rho,
                             ilam_row[0],
                             aux=(tau, jnp.zeros((n,), dtype)),
                             dtype=dtype)

            def step(st, il):
                from ..core.engine import warm_start

                st = warm_start(st, il)
                if trace_len is None:
                    st = solve(st, maxit, eps_abs, eps_rel)
                    buf = None
                else:
                    st, buf = solve_t(st, maxit, eps_abs, eps_rel)
                return st, (st.z[n:], st.it, buf)

            _, (coefs, niter, traces) = lax.scan(step, st0, ilam_row)
            return coefs, niter, traces

        coefs, niter, traces = jax.vmap(one_tau)(taus, ilams)

    if intercept:
        a, slopes = coefs[..., 0], coefs[..., 1:]
        coef = slopes / sd_x * sd_y
        beta0 = mean_y + sd_y * a - jnp.sum(coef * mean_x, axis=-1)
    else:
        coef = coefs / sd_x * sd_y
        beta0 = jnp.zeros(coef.shape[:-1], dtype)
    return QuantilePathResult(taus=taus, lambdas=lams, beta0=beta0,
                              coef=coef, niter=niter, trace=traces)


def quantile_lasso_path(X, y, *, tau=0.5,
                        lambdas: Optional[jnp.ndarray] = None,
                        nlambda: int = 30,
                        lambda_min_ratio: float = 1e-2,
                        standardize: bool = True, intercept: bool = True,
                        weights=None, maxit: int = 20000,
                        eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                        rho: float = -1.0, path_mode: str = "batch",
                        trace_len: Optional[int] = None,
                        dtype=jnp.float32) -> QuantilePathResult:
    """Solve l1-penalized quantile-regression paths on device.

    ``tau``: a scalar or a 1-D grid of quantile levels — every
    (tau, lambda) pair is a batched lane in ONE while_loop
    (``path_mode="batch"``, default) or a warm-started per-tau scan
    (``"scan"``).  The auto lambda grid is PER TAU (each tau's exact
    null threshold tops its grid); explicit ``lambdas`` are shared.
    Result arrays carry a leading (T,) tau axis (squeeze it for scalar
    tau).  ``weights`` enter the check loss directly (weight-0 rows
    drop out exactly — the one-pass CV mechanism).  The intercept is
    free (unpenalized) and optimized under the check loss.  Oracle:
    sklearn ``QuantileRegressor`` (tests/test_quantile.py)."""
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    taus = jnp.atleast_1d(jnp.asarray(tau, dtype))
    t_np = np.asarray(taus, np.float64)
    if np.any(t_np <= 0) or np.any(t_np >= 1):
        raise ValueError("tau values must be in (0, 1)")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"        # per-(tau, lambda) residual buffers
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else jnp.sort(jnp.atleast_1d(
                jnp.asarray(lambdas, dtype)))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    return _quantile_path_dev(X, y, taus, int(nlambda),
                              lambda_min_ratio, lams, rho, maxit,
                              eps_abs, eps_rel, w,
                              standardize_x=standardize,
                              intercept=intercept, path_mode=path_mode,
                              trace_len=trace_len)


@partial(jax.jit, static_argnames=("standardize_x", "intercept"))
def _quantile_fold_etas(X, y, taus, lams, masks, fid, rho, maxit,
                        eps_abs, eps_rel, *, standardize_x, intercept):
    """Jitted one-pass fold sweep (the cv.py fold-as-lane pattern):
    fold f = the weighted path with weight 0 on held-out rows; returns
    the (n, T, L) own-fold linear predictors."""
    def one(mask):
        res = _quantile_path_dev(X, y, taus, 2, 1e-2, lams, rho, maxit,
                                 eps_abs, eps_rel, mask,
                                 standardize_x=standardize_x,
                                 intercept=intercept,
                                 path_mode="batch")
        return res.beta0[..., None] + dot(res.coef, X.T)   # (T, L, n)

    etas = jax.vmap(one)(masks)                    # (F, T, L, n)
    return etas[fid, :, :, jnp.arange(fid.shape[0])]


def pinball_loss(eta, y, tau):
    """Per-observation check loss at level tau (the CV criterion)."""
    r = y - eta
    return np.where(r > 0, tau * r, (tau - 1.0) * r)


def cv_quantile_lasso_path(X, y, *, tau=0.5, nfolds: int = 10,
                           nlambda: int = 30, seed: int = 0,
                           foldid: Optional[np.ndarray] = None,
                           lambdas=None, standardize: bool = True,
                           intercept: bool = True, weights=None,
                           cv_mode: str = "onepass", maxit: int = 20000,
                           eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                           rho: float = -1.0, dtype=jnp.float32):
    """K-fold CV of the penalized quantile path, scored by the PINBALL
    (check) loss at each tau — every fold x tau x lambda in one
    compiled program (``cv_mode="onepass"``; "loop" keeps the host
    fold loop as the cross-check).  Returns a dict with per-tau
    ``cvm``/``cvsd`` (T, L), ``lambda_min``/``lambda_1se`` (T,), and
    the full-data fit."""
    from .cv import _cv_foldid

    if cv_mode not in ("onepass", "loop"):
        raise ValueError("cv_mode must be 'onepass' or 'loop'")
    X_np = np.asarray(X, np.float64)
    y_np = np.asarray(y, np.float64).ravel()
    n = X_np.shape[0]
    taus_np = np.atleast_1d(np.asarray(tau, np.float64))
    full = quantile_lasso_path(X_np, y_np, tau=taus_np, nlambda=nlambda,
                               lambdas=lambdas, standardize=standardize,
                               intercept=intercept, weights=weights,
                               maxit=maxit, eps_abs=eps_abs,
                               eps_rel=eps_rel, rho=rho, dtype=dtype)
    # Fold fits share the full-data per-tau grids (glmnet convention);
    # the (T, L) grid matrix feeds the fold sweep directly, so ALL
    # folds x taus x lambdas run as one compiled program and one
    # host pull.
    lams_all = np.asarray(full.lambdas, np.float64)     # (T, L)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)
    masks = (foldid[None, :] != np.arange(nfolds)[:, None]
             ).astype(np.float64)
    w_np = (None if weights is None
            else np.asarray(weights, np.float64).ravel())
    if w_np is not None:
        masks = masks * w_np[None, :]
    T, L = lams_all.shape

    eta = np.empty((n, T, L))
    if cv_mode == "onepass":
        eta = np.asarray(_quantile_fold_etas(
            jnp.asarray(X_np, dtype), jnp.asarray(y_np, dtype),
            jnp.asarray(taus_np, dtype),
            jnp.asarray(lams_all, dtype),
            jnp.asarray(masks, dtype),
            jnp.asarray(np.clip(foldid, 0, None), jnp.int32),
            jnp.asarray(rho, dtype), maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept),
            np.float64)
    else:
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            wf = None if w_np is None else w_np[tr]
            for t in range(T):
                rf = quantile_lasso_path(
                    X_np[tr], y_np[tr], tau=taus_np[t],
                    lambdas=lams_all[t], standardize=standardize,
                    intercept=intercept, weights=wf, maxit=maxit,
                    eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                    dtype=dtype)
                eta[va, t] = (np.asarray(rf.beta0)[0][None, :]
                              + X_np[va] @ np.asarray(rf.coef)[0].T)

    scored = foldid >= 0
    ws = (np.ones(n) if w_np is None else w_np)[scored]
    err = np.stack([pinball_loss(eta[scored, t], y_np[scored, None],
                                 taus_np[t]) for t in range(T)], axis=1)
    cvm = (ws[:, None, None] * err).sum(axis=0) / ws.sum()   # (T, L)
    cvsd = np.sqrt((ws[:, None, None] * (err - cvm) ** 2).sum(axis=0)
                   / ws.sum() / (scored.sum() - 1))
    i_min = np.argmin(cvm, axis=1)
    lam_min = lams_all[np.arange(T), i_min]
    lam_1se = np.empty(T)
    for t in range(T):
        ok = cvm[t] <= cvm[t, i_min[t]] + cvsd[t, i_min[t]]
        lam_1se[t] = lams_all[t, np.flatnonzero(ok)[0]]
    return dict(taus=taus_np, lambdas=lams_all, cvm=cvm, cvsd=cvsd,
                lambda_min=lam_min, lambda_1se=lam_1se, fit=full,
                foldid=foldid)
