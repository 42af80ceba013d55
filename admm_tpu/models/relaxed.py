"""Relaxed Lasso (glmnet's ``relax = TRUE``).

The lasso's shrinkage biases the coefficients of the variables it
selects; the RELAXED lasso (Meinshausen 2007; glmnet's formulation)
de-biases by blending each path point with the UNPENALIZED least-squares
refit on that point's support ::

    b_relaxed(lambda, gamma) = gamma * b_lasso(lambda)
                               + (1 - gamma) * b_refit(support(lambda))

``gamma = 1`` is the lasso; ``gamma = 0`` the pure refit.

Structure: the refits for ALL path points run inside one
XLA program — per lambda the masked normal equations ::

    (M X'X M + (I - M)) b = M X'y,   M = diag(support mask)

reproduce the support-restricted LS solve with STATIC shapes (off-
support rows reduce to b_j = 0; no gather, no dynamic support size —
the same design rule as the rest of the framework), sequenced with
``lax.map`` so only one (p, p) system is live at a time.  The blend is
affine, and coefficient recovery is affine in the coefficients, so
blending on the original scale equals blending the standardized solves.

Supports past n rows make the refit system singular; a relative jitter
regularizes it (glmnet's dense refit has the same caveat).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..data.standardize import recover, standardize
from ..linalg import dot, gram
from .lasso import PathResult, lasso_path


class RelaxedPathResult(NamedTuple):
    """Relaxed-lasso result: a (gamma, lambda) grid of solutions."""
    lambdas: jnp.ndarray   # (L,)
    gammas: jnp.ndarray    # (G,)
    beta0: jnp.ndarray     # (G, L)
    coef: jnp.ndarray      # (G, L, p)
    fit: PathResult        # the underlying lasso path (gamma = 1)
    refit_beta0: jnp.ndarray  # (L,) unpenalized refit intercepts
    refit_coef: jnp.ndarray   # (L, p) unpenalized refits (gamma = 0)


@partial(jax.jit, static_argnames=("standardize_x", "intercept"))
def _masked_refits(X, y, masks, weights=None, *, standardize_x,
                   intercept):
    """(L, p) unpenalized LS refits restricted to each row of ``masks``
    (one compiled program; lax.map keeps one (p, p) system live).
    ``weights`` make the refit the WEIGHTED least squares matching the
    weighted lasso it de-biases (sqrt(w) row scaling via the shared
    standardization)."""
    import jax.scipy.linalg as jsl

    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    XtX = gram(Xs)
    Xty = dot(Xs.T, ys)
    p = XtX.shape[0]
    # Relative jitter: exact LS when the support is well-posed, ridge
    # regularization when |S| > n makes it singular.
    jit = 1e-6 * jnp.mean(jnp.diag(XtX))

    def one(m):
        A = (XtX * (m[:, None] * m[None, :])
             + jnp.diag(1.0 - m + jit * m))
        c, low = jsl.cho_factor(A)
        return jsl.cho_solve((c, low), m * Xty) * m

    refits_std = lax.map(one, masks)
    beta0, coef = recover(stats, refits_std, standardize_x=standardize_x,
                          intercept=intercept)
    return beta0, coef


def relaxed_lasso_path(X, y, *, gammas=(0.0, 0.25, 0.5, 0.75, 1.0),
                       standardize: bool = True, intercept: bool = True,
                       dtype=jnp.float32, **lasso_kw) -> RelaxedPathResult:
    """Fit the relaxed-lasso (lambda, gamma) grid (module docstring).

    ``lasso_kw`` forwards to :func:`admm_tpu.models.lasso.lasso_path`
    (lambdas/nlambda, eps, rho, path_mode, weights, ...).  Returns the
    full (G, L) solution grid plus the underlying lasso path and the
    pure refits; ``gamma = 1`` reproduces the lasso exactly.
    """
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    gam = jnp.sort(jnp.asarray(gammas, dtype).ravel())
    if (lasso_kw.get("lower_limits") is not None
            or lasso_kw.get("upper_limits") is not None):
        # The unpenalized refit would need a box-CONSTRAINED LS solve
        # (an active-set problem, not a clip) to stay feasible; rather
        # than silently return infeasible refits, refuse.
        raise NotImplementedError(
            "relaxed_lasso_path does not support coefficient limits "
            "(the support refit would need constrained least squares)")
    res = lasso_path(X, y, standardize=standardize, intercept=intercept,
                     dtype=dtype, **lasso_kw)
    coefs = jnp.asarray(res.coef)
    masks = (jnp.abs(coefs) > 0).astype(dtype)      # (L, p)
    w = lasso_kw.get("weights")
    w = None if w is None else jnp.asarray(w, dtype)
    refit_beta0, refit_coef = _masked_refits(
        X, y, masks, w, standardize_x=standardize, intercept=intercept)
    g = gam[:, None, None]
    coef = g * coefs[None] + (1.0 - g) * refit_coef[None]
    beta0 = (gam[:, None] * jnp.asarray(res.beta0)[None]
             + (1.0 - gam[:, None]) * refit_beta0[None])
    return RelaxedPathResult(lambdas=res.lambdas, gammas=gam,
                             beta0=beta0, coef=coef, fit=res,
                             refit_beta0=refit_beta0,
                             refit_coef=refit_coef)


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "enet_scale"))
def _relaxed_fold_etas(X, y, lams, gam, masks, fid, rho, maxit,
                       eps_abs, eps_rel, alpha, *, standardize_x,
                       intercept, enet_scale=False):
    """Jitted ONE-PROGRAM CV fold sweep for the relaxed lasso: per
    fold-mask lane, the weighted lasso path AND the weighted support
    refits run together; the gamma blend is AFFINE in the linear
    predictor, so the two eta matrices are built once (two matmuls)
    and blended — no (G, L, p) coefficient temporaries.  Returns the
    (n, G, L) own-fold linear predictors."""
    from .lasso import _path_user

    def one(wmask):
        res = _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel,
                         alpha, wmask, None, None,
                         standardize_x=standardize_x,
                         intercept=intercept, enet_scale=enet_scale,
                         path_mode="batch")
        supp = (jnp.abs(res.coef) > 0).astype(X.dtype)
        rb0, rcoef = _masked_refits(X, y, supp, wmask,
                                    standardize_x=standardize_x,
                                    intercept=intercept)
        eta_l = res.beta0[:, None] + dot(res.coef, X.T)    # (L, n)
        eta_r = rb0[:, None] + dot(rcoef, X.T)             # (L, n)
        g = gam[:, None, None]
        return g * eta_l[None] + (1.0 - g) * eta_r[None]   # (G, L, n)

    etas = jax.vmap(one)(masks)                    # (F, G, L, n)
    return etas[fid, :, :, jnp.arange(fid.shape[0])]   # (n, G, L)


def cv_relaxed_lasso_path(X, y, *, nfolds: int = 10,
                          gammas=(0.0, 0.25, 0.5, 0.75, 1.0),
                          nlambda: int = 100, seed: int = 0,
                          foldid: Optional[np.ndarray] = None,
                          standardize: bool = True,
                          intercept: bool = True, cv_mode: str = "auto",
                          fold_mesh=None, **lasso_kw):
    """Cross-validate the (lambda, gamma) grid jointly (glmnet's
    ``cv.glmnet(..., relax = TRUE)``).

    The expensive per-fold work — the lasso path and the support refits
    — is computed ONCE per fold; every gamma is scored from the same
    two solution sets by blending at prediction time.  ``cv_mode``:
    "onepass" (the default via "auto" for the plain argument surface)
    runs the whole fold sweep — weighted paths AND weighted refits —
    as one compiled program; "loop" refits per fold on the host (the
    fallback when extra lasso arguments are passed).  Returns a dict
    with the (G, L) ``cvm``/``cvsd`` matrices, the selected
    ``lambda_min``/``gamma_min``, and the full-data
    :class:`RelaxedPathResult`.
    """
    from .cv import _cv_foldid

    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).ravel()
    n = X.shape[0]
    gam = np.sort(np.asarray(gammas, np.float64).ravel())
    full = relaxed_lasso_path(X, y, gammas=gam, standardize=standardize,
                              intercept=intercept, nlambda=nlambda,
                              **lasso_kw)
    lams = np.asarray(full.lambdas, np.float64)
    lasso_kw.pop("lambdas", None)   # fold refits get the shared grid
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    simple = not (set(lasso_kw)
                  - {"alpha", "weights", "rho", "maxit", "eps_abs",
                     "eps_rel", "lambda_min_ratio", "dtype",
                     "_enet_scale"})
    onepass = cv_mode != "loop" and simple
    if cv_mode == "onepass" and not simple:
        raise ValueError("cv_mode='onepass' supports the plain relaxed "
                         "argument surface (alpha/weights/rho/maxit/"
                         "eps); drop the extra arguments or use "
                         "cv_mode='loop'")
    G, L = gam.shape[0], lams.shape[0]
    err = np.full((n, G, L), np.nan)
    if onepass:
        dtype = lasso_kw.get("dtype", jnp.float32)
        w = lasso_kw.get("weights")
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * np.asarray(w, np.float64).ravel()[None, :]
        from .cv import _shard_folds

        eta_all = np.asarray(_relaxed_fold_etas(
            jnp.asarray(X, dtype), jnp.asarray(y, dtype),
            jnp.asarray(lams, dtype), jnp.asarray(gam, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(np.clip(foldid, 0, None), jnp.int32),
            lasso_kw.get("rho", -1.0), lasso_kw.get("maxit", 10000),
            lasso_kw.get("eps_abs", 1e-5), lasso_kw.get("eps_rel", 1e-5),
            lasso_kw.get("alpha", 1.0),
            standardize_x=standardize, intercept=intercept,
            enet_scale=bool(lasso_kw.get("_enet_scale", False))),
            np.float64)                            # (n, G, L)
        err = (eta_all - y[:, None, None]) ** 2
    else:
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            kw_f = dict(lasso_kw)
            if kw_f.get("weights") is not None:
                kw_f["weights"] = np.asarray(
                    kw_f["weights"], np.float64).ravel()[tr]
            rf = relaxed_lasso_path(X[tr], y[tr], gammas=gam,
                                    standardize=standardize,
                                    intercept=intercept, lambdas=lams,
                                    **kw_f)
            pred = (np.asarray(rf.beta0)[:, :, None]
                    + np.einsum("vp,glp->glv", X[va],
                                np.asarray(rf.coef)))   # (G, L, n_va)
            err[va] = ((pred - y[va][None, None, :]) ** 2
                       ).transpose(2, 0, 1)

    scored = foldid >= 0
    n_sc = int(scored.sum())
    w_all = lasso_kw.get("weights")
    if w_all is None:
        cvm = err[scored].mean(axis=0)               # (G, L)
        cvsd = np.sqrt(((err[scored] - cvm) ** 2).mean(axis=0)
                       / (n_sc - 1))
    else:
        # glmnet's weighted cvm/cvsd (cv.py::_cv_curve convention).
        ws = np.asarray(w_all, np.float64).ravel()[scored]
        cvm = ((ws[:, None, None] * err[scored]).sum(axis=0)
               / ws.sum())
        cvsd = np.sqrt((ws[:, None, None] * (err[scored] - cvm) ** 2)
                       .sum(axis=0) / ws.sum() / (n_sc - 1))
    gi, li = np.unravel_index(int(np.argmin(cvm)), cvm.shape)
    return dict(lambdas=lams, gammas=gam, cvm=cvm, cvsd=cvsd,
                lambda_min=float(lams[li]), gamma_min=float(gam[gi]),
                fit=full, foldid=foldid)
