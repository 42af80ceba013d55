"""K-fold cross-validation over the lambda path.

The reference has no model selection at all — users eyeball the solution
path plot (reference: R/30_admm_lasso.R:189-214).  Here the design
rule "everything lives inside one XLA program" (DESIGN.md) extends to
the FOLD axis: the default ``cv_mode="onepass"`` runs every fold's whole
path sweep as ONE compiled program — fold f is the weighted path with
weight 0 on its held-out rows (exactly the training-subset fit: the
weights are renormalized to sum to n, so the fold objective matches the
subset objective term for term), vmapped over the (nfolds, n) mask
matrix, with on-device prediction of the (nfolds, nlambda, n) linear
predictors.  The host does only the final per-observation loss +
cvm/cvsd reduce.  A 10-fold CV is then 2 device dispatches (full fit +
fold sweep) instead of 11, each of which waits on a host round trip.
``cv_mode="loop"`` keeps the host-side fold loop (the
fallback; EVERY family's CV — gaussian, the GLM tier, the matrix
families, (sparse-)group/generalized Lasso, the relaxed lasso,
Dantzig, and cox — runs one-pass by default).

Conventions follow glmnet's ``cv.glmnet``: the lambda grid is computed
once on the full data; per-fold models are fit on the training split and
scored by mean-squared prediction error on the held-out split;
``lambda_min`` minimises the CV curve and ``lambda_1se`` is the largest
lambda within one standard error of the minimum.  ``weights`` (glmnet's
``weights`` in ``cv.glmnet``) weight both the fits and the cvm/cvsd
aggregation.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..linalg import dot
from .lasso import PathResult, lasso_path


class CVResult(NamedTuple):
    lambdas: np.ndarray     # (nlambda,) the shared grid
    cvm: np.ndarray         # (nlambda,) mean CV MSE
    cvsd: np.ndarray        # (nlambda,) standard error of the CV MSE
    lambda_min: float       # grid point minimising cvm
    lambda_1se: float       # largest lambda with cvm <= min + 1 se
    fit: PathResult         # full-data path fit on the same grid
    foldid: np.ndarray      # (n,) fold assignment (-1 = train-only row)
    # glmnet's keep=TRUE: the (n, nlambda) PREVALIDATED linear
    # predictors (each row from the fold fit that excluded it), or None
    fit_preval: Optional[np.ndarray] = None


def _squared_error(eta, y):
    """Per-observation squared error (gaussian; glmnet type.measure
    'mse').  ``eta`` is the (nlambda, n_va) linear predictor."""
    return (eta - y[None, :]) ** 2


def binomial_deviance(eta, y):
    """Per-observation binomial deviance (glmnet type.measure
    'deviance' for family='binomial'): -2[y log p + (1-y) log(1-p)]
    computed stably from the linear predictor."""
    # log(1 + exp(eta)) - y*eta, doubled; logaddexp is overflow-safe.
    return 2.0 * (np.logaddexp(0.0, eta) - y[None, :] * eta)


def _make_family_score_reduce(err_fn):
    """Jitted device reducer for a family's JNP cv_loss twin — memoized
    per family function so repeated CVs reuse one compiled program
    (GLMFamily constructors are lru_cached, so err_fn identity is
    stable)."""
    cached = _FAMILY_REDUCE_CACHE.get(err_fn)
    if cached is not None:
        return cached

    @jax.jit
    def reduce(eta, y, ws, n_sc):
        err = err_fn(eta.T, y).T          # cv_loss is (L, n) x (n,)
        sw = jnp.sum(ws)
        cvm = dot(ws, err) / sw
        cvsd = jnp.sqrt(dot(ws, (err - cvm[None, :]) ** 2) / sw
                        / jnp.maximum(n_sc - 1.0, 1.0))
        return jnp.stack([cvm, cvsd])

    _FAMILY_REDUCE_CACHE[err_fn] = reduce
    return reduce


_FAMILY_REDUCE_CACHE: dict = {}


@partial(jax.jit, static_argnames=("kind",))
def _score_reduce_dev(eta, y, ws, n_sc, kind):
    """Device-side cvm/cvsd reduction for the one-pass sweep.

    Shipping the (n, nlambda) eta matrix to the host for numpy
    scoring dominated the one-pass CV's wall time in the roofline
    study made before the GPU port (DESIGN.md "Roofline").  For the
    standard per-observation measures the weighted
    mean/sd reduce on device (glmnet's exact formulas, two-pass for
    the sd) and only two (nlambda,) vectors cross the link.  ``ws`` is
    the scoring weight vector (0 on unscored rows)."""
    if kind == "mse":
        err = (eta - y[:, None]) ** 2
    else:  # "mae"
        err = jnp.abs(eta - y[:, None])
    sw = jnp.sum(ws)
    cvm = dot(ws, err) / sw
    cvsd = jnp.sqrt(dot(ws, (err - cvm[None, :]) ** 2) / sw
                    / jnp.maximum(n_sc - 1.0, 1.0))
    # ONE stacked array = ONE host pull (each blocking transfer is a
    # device-to-host round trip).
    return jnp.stack([cvm, cvsd])


def _resolve_measure(type_measure, fam, default_loss):
    """glmnet's ``type.measure`` -> a per-observation ``loss(eta, y)``
    (or the 'auc' sentinel, handled per fold by the caller).

    Gaussian (``fam`` None): 'default'/'mse' (squared error), 'mae'.
    GLM families: 'default'/'deviance' (the family's CV loss),
    'mse'/'mae' on the RESPONSE scale (expit for binomial, exp for
    poisson, the identity for huber — glmnet's definitions), and for
    binomial additionally 'class' (misclassification at p = 1/2) and
    'auc' (per-fold, Mann-Whitney).
    """
    if type_measure in ("default", None):
        return default_loss, "min"
    name = getattr(fam, "name", "gaussian") if fam is not None \
        else "gaussian"

    def response(eta):
        # Family objects carry their own inverse link (mean_eta) —
        # probit/cloglog/gamma/negbin score mse/mae on the mean scale.
        if fam is not None and getattr(fam, "mean_eta", None) is not None:
            return fam.mean_eta(eta)
        if name == "binomial":
            return 1.0 / (1.0 + np.exp(-eta))
        if name == "poisson":
            return np.exp(eta)
        return eta

    if type_measure == "deviance":
        if fam is None:
            return _squared_error, "min"      # gaussian deviance == mse
        return default_loss, "min"
    if type_measure == "mse":
        return (lambda eta, y: (response(eta) - y[None, :]) ** 2), "min"
    if type_measure == "mae":
        return (lambda eta, y:
                np.abs(response(eta) - y[None, :])), "min"
    if type_measure == "class":
        if not name.startswith("binomial"):
            raise ValueError("type_measure='class' needs a binomial "
                             "family (or cv_multinomial_path)")
        # Misclassification at mean = 1/2 — every binomial link's
        # inverse is monotone increasing through mean(eta*) = 1/2, so
        # thresholding the RESPONSE keeps the rule link-correct
        # (logit/probit: eta > 0; cloglog: eta > log log 2).
        return (lambda eta, y:
                ((response(eta) > 0.5).astype(float) != y[None, :])
                .astype(float)), "min"
    if type_measure == "auc":
        if not name.startswith("binomial"):
            raise ValueError(
                "type_measure='auc' needs a binomial family")
        return "auc", "max"
    raise ValueError(
        f"unknown type_measure {type_measure!r}; choose from "
        "'default', 'deviance', 'mse', 'mae', 'class', 'auc'")


def _fold_auc(eta_all, y, foldid, nfolds, w=None):
    """Per-fold AUC (Mann-Whitney / normalized rank-sum, glmnet's
    type.measure='auc'): returns (cvraw (nfolds, L), fold_w (nfolds,))
    with weight 0 for degenerate folds (a single class — AUC
    undefined; glmnet recommends small nfolds for exactly this
    reason)."""
    L = eta_all.shape[1]
    cvraw = np.zeros((nfolds, L))
    fold_w = np.zeros(nfolds)
    for f in range(nfolds):
        va = foldid == f
        yv = y[va]
        npos = int((yv == 1).sum())
        nneg = int((yv == 0).sum())
        if npos == 0 or nneg == 0:
            continue
        ev = eta_all[va]                      # (n_va, L)
        # column-wise rank of positives among all (average ranks for
        # ties via double argsort on a stable sort of (value, index))
        from scipy.stats import rankdata
        ranks = np.apply_along_axis(rankdata, 0, ev)
        rpos = ranks[yv == 1].sum(axis=0)
        cvraw[f] = (rpos - npos * (npos + 1) / 2.0) / (npos * nneg)
        fold_w[f] = float(va.sum()) if w is None else float(w[va].sum())
    if fold_w.sum() == 0:
        raise ValueError("AUC is undefined in every fold (each fold "
                         "held a single class); use fewer folds")
    return cvraw, fold_w


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "enet_scale"))
def _gaussian_fold_etas(X, y, lams, masks, fid, rho, maxit, eps_abs,
                        eps_rel, alpha, pf=None, limits=None, *,
                        standardize_x, intercept, enet_scale):
    """Jitted CORE of the gaussian fold sweep — a MODULE-LEVEL jit so
    compilations cache across cv_lasso_path calls (a per-call
    ``jax.jit`` closure recompiled the whole vmapped program every CV:
    a recompile of the whole vmapped program on every call).

    Returns the (n, nlambda) OWN-FOLD linear predictors — each row
    selected from its own fold's sweep ON DEVICE (``fid`` = clipped
    foldid), so only n*nlambda floats cross the host link instead of
    the full (nfolds, nlambda, n) tensor."""
    from .lasso import _path_user

    def one(mask):
        res = _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel,
                         alpha, mask, pf, limits,
                         standardize_x=standardize_x,
                         intercept=intercept, enet_scale=enet_scale,
                         path_mode="batch")
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)                # (nfolds, nlambda, n)
    return etas[fid, :, jnp.arange(fid.shape[0])]


def _make_gaussian_fold_eta(alpha, enet_scale, standardize, intercept,
                            solver_kw):
    """Build the one-program fold sweep for the gaussian Lasso/Enet:
    ``run(X, y, lams, masks) -> (nfolds, nlambda, n)`` linear predictors,
    ONE compiled XLA program (vmap over the fold-mask axis of the
    weighted batched path solver).  A device-resident ``X`` is used in place
    (no host round-trip)."""
    rho = solver_kw.get("rho", -1.0)
    maxit = solver_kw.get("maxit", 10000)
    eps_abs = solver_kw.get("eps_abs", 1e-5)
    eps_rel = solver_kw.get("eps_rel", 1e-5)
    dtype = solver_kw.get("dtype", jnp.float32)
    fold_mesh = solver_kw.get("fold_mesh")

    def run(X, y, lams, masks, fid):
        # The fold solves must see EXACTLY the full fit's normalized
        # factors/box — including ``exclude`` merged into the
        # lower=upper=0 box (same shared validator as the public path,
        # models/lasso.py::validate_pf_limits).
        from .lasso import validate_pf_limits

        pf, lim = validate_pf_limits(
            solver_kw.get("penalty_factor"), solver_kw.get("exclude"),
            solver_kw.get("lower_limits"), solver_kw.get("upper_limits"),
            np.shape(X)[1], dtype)
        masks_j = _shard_folds(jnp.asarray(masks, dtype), fold_mesh)
        return _gaussian_fold_etas(
            jnp.asarray(X, dtype), jnp.asarray(y, dtype),
            jnp.asarray(lams, dtype), masks_j,
            jnp.asarray(fid, jnp.int32),
            rho, maxit, eps_abs, eps_rel, alpha, pf, lim,
            standardize_x=standardize, intercept=intercept,
            enet_scale=enet_scale)

    return run


@partial(jax.jit, static_argnames=("family", "standardize_x",
                                   "intercept", "path_mode",
                                   "newton_steps"))
def _glm_fold_etas(X, y, lams, masks, fid, rho, maxit, eps_abs,
                   eps_rel, alpha, pf=None, limits=None, off=None, *,
                   family, standardize_x, intercept, path_mode,
                   newton_steps):
    """Jitted core of the GLM fold sweep (module-level for cache reuse
    and on-device own-fold selection, as
    :func:`_gaussian_fold_etas`).  ``off`` (glmnet's ``offset``) enters
    every fold fit AND the returned linear predictors, so held-out
    scoring sees eta = b0 + Xb + offset exactly as glmnet's cvraw."""
    from .glm import _glm_path

    def one(mask):
        res = _glm_path(X, y, 2, 1e-2, lams, rho, maxit, eps_abs,
                        eps_rel, alpha, mask, off, pf, limits,
                        family=family,
                        standardize_x=standardize_x,
                        intercept=intercept, path_mode=path_mode,
                        newton_steps=newton_steps)
        eta = res.beta0[:, None] + dot(res.coef, X.T)
        return eta if off is None else eta + off[None, :]

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "standardize_y", "penalty"))
def _mt_fold_etas(X, Y, lams, masks, fid, rho, maxit, eps_abs, eps_rel,
                  pf=None, keep=None, alpha=1.0, *, standardize_x,
                  intercept, standardize_y, penalty="rows"):
    """Jitted one-program CV fold sweep for the multi-task Lasso
    (the (p, K)-block analog of :func:`_glm_fold_etas`): fold f is the
    weighted path with weight 0 on held-out rows, vmapped; returns the
    (n, L, K) OWN-FOLD linear predictors selected on device."""
    from .multitask import _mt_path

    def one(mask):
        res = _mt_path(X, Y, 2, 1e-2, lams, rho, maxit, eps_abs,
                       eps_rel, mask, pf, keep, alpha,
                       standardize_x=standardize_x, intercept=intercept,
                       path_mode="batch", standardize_y=standardize_y,
                       penalty=penalty)
        return res.beta0[:, None, :] + jnp.einsum(
            "np,lpk->lnk", X, res.coef, precision=jax.lax.Precision.HIGHEST)

    etas = jax.vmap(one)(masks)                   # (F, L, n, K)
    return etas[fid, :, jnp.arange(fid.shape[0])]  # (n, L, K)


@partial(jax.jit, static_argnames=("nclass", "standardize_x",
                                   "intercept", "grouped",
                                   "newton_steps"))
def _mn_fold_etas(X, y, lams, masks, fid, rho, maxit, eps_abs, eps_rel,
                  alpha, pf=None, keep_p=None, off=None, *, nclass,
                  standardize_x, intercept, grouped, newton_steps):
    """Jitted one-program CV fold sweep for the multinomial path;
    returns the (n, L, C) own-fold linear predictors (offset
    INCLUDED, so scoring sees glmnet's eta)."""
    from .multinomial import _mn_path

    def one(mask):
        res = _mn_path(X, y, 2, 1e-2, lams, rho, maxit, eps_abs,
                       eps_rel, alpha, mask, pf, keep_p, off,
                       nclass=nclass, standardize_x=standardize_x,
                       intercept=intercept, path_mode="batch",
                       grouped=grouped, newton_steps=newton_steps)
        eta = res.beta0[:, None, :] + jnp.einsum(
            "np,lpc->lnc", X, res.coef, precision=jax.lax.Precision.HIGHEST)
        return eta if off is None else eta + off[None, :, :]

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]  # (n, L, C)


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "l1_ratio"))
def _group_fold_etas(X, y, groups, gweights, lams, masks, fid, rho,
                     maxit, eps_abs, eps_rel, *, standardize_x,
                     intercept, l1_ratio):
    """Jitted one-program CV fold sweep for the (sparse-)group Lasso
    (weight-zero fold lanes over ``_gl_path``'s ``obs_weights``)."""
    from .grouplasso import _gl_path

    def one(mask):
        res = _gl_path(X, y, groups, gweights, 2, 1e-2, lams, rho,
                       maxit, eps_abs, eps_rel, mask,
                       standardize_x=standardize_x, intercept=intercept,
                       l1_ratio=l1_ratio)
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "path_mode"))
def _dz_fold_etas(X, y, lams, masks, fid, rho, maxit, eps_abs, eps_rel,
                  *, standardize_x, intercept, path_mode):
    """Jitted one-program CV fold sweep for the Dantzig selector
    (weight-zero fold lanes over the weighted engine)."""
    from .dantzig import _dpath_user

    def one(mask):
        res = _dpath_user(X, y, lams, rho, maxit, eps_abs, eps_rel,
                          mask, standardize_x=standardize_x,
                          intercept=intercept, path_mode=path_mode)
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]


@partial(jax.jit, static_argnames=("intercept",))
def _gen_fold_etas(X, y, D, lams, masks, fid, rho, maxit, eps_abs,
                   eps_rel, *, intercept):
    """Jitted one-program CV fold sweep for the generalized Lasso."""
    from .genlasso import _gen_path

    def one(mask):
        res = _gen_path(X, y, D, 2, 1e-2, lams, rho, maxit, eps_abs,
                        eps_rel, mask, intercept=intercept,
                        path_mode="batch")
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]


def _shard_folds(masks_j, fold_mesh):
    """Embarrassingly parallel CV: shard the FOLD axis of the mask
    matrix over ``fold_mesh`` — the vmapped fold sweep then partitions
    lane-wise, each device solving its folds' whole paths; the only
    cross-device traffic is the batched while_loop's tiny all-done
    reduction and the final eta gather."""
    if fold_mesh is None:
        return masks_j
    from jax.sharding import NamedSharding, PartitionSpec

    axes = tuple(fold_mesh.axis_names)
    return jax.device_put(
        masks_j, NamedSharding(fold_mesh, PartitionSpec(axes, None)))


def _make_glm_fold_eta(fam, alpha, standardize, intercept, maxit,
                       eps_abs, eps_rel, rho, path_mode, dtype=None,
                       fold_mesh=None, newton_steps=None,
                       penalty_factor=None, lower_limits=None,
                       upper_limits=None, exclude=None, offset=None):
    """One-program fold sweep for any GLM family (same contract as
    :func:`_make_gaussian_fold_eta`): fold f = the weighted GLM path
    with weight 0 on held-out rows (models/glm.py), vmapped."""
    dtype = jnp.float32 if dtype is None else dtype

    def run(X, y, lams, masks, fid):
        from .lasso import validate_pf_limits

        pf, lim = validate_pf_limits(penalty_factor, exclude,
                                     lower_limits, upper_limits,
                                     np.shape(X)[1], dtype)
        off = None if offset is None \
            else jnp.asarray(offset, dtype).ravel()
        return _glm_fold_etas(
            jnp.asarray(X, dtype), jnp.asarray(y, dtype),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32),
            rho, maxit, eps_abs, eps_rel, alpha, pf, lim, off,
            family=fam,
            standardize_x=standardize, intercept=intercept,
            path_mode=path_mode,
            newton_steps=_default_newton_steps(fam, newton_steps))

    return run


def _default_newton_steps(fam, newton_steps):
    """The family's shipped x-update default (poisson runs ONE exact
    Newton step per warm-started update — measured equivalent and ~2x
    cheaper, models/glm.py::poisson_lasso_path) unless overridden."""
    from .glm import _NEWTON_STEPS

    if newton_steps is not None:
        return int(newton_steps)
    return 1 if getattr(fam, "name", "") == "poisson" else _NEWTON_STEPS


def cv_lasso_path(X, y, *, nfolds: int = 10, nlambda: int = 100,
                  lambda_min_ratio: Optional[float] = None,
                  lambdas: Optional[np.ndarray] = None,
                  alpha: float = 1.0, _enet_scale: bool = False,
                  standardize: bool = True, intercept: bool = True,
                  seed: int = 0, foldid: Optional[np.ndarray] = None,
                  path_mode: str = "batch", cv_mode: str = "auto",
                  weights: Optional[np.ndarray] = None,
                  offset: Optional[np.ndarray] = None,
                  type_measure: str = "default", keep: bool = False,
                  _path_fn=None, _loss_fn=None, _fold_eta_fn=None,
                  _family=None, **solver_kw) -> CVResult:
    """Cross-validated Lasso/Elastic-Net path.

    Fold assignment and scoring follow ``cv.glmnet`` exactly: rows are
    randomly assigned round-robin over a permutation, so fold sizes
    differ by at most one and EVERY row is scored.  Errors are
    aggregated per OBSERVATION, not per fold: ``cvm`` is the mean
    squared prediction error over all scored rows and ``cvsd`` its
    standard error (glmnet's ``cvraw``/``cvsd`` formula), so unequal
    explicit folds are weighted by their size automatically.

    ``cv_mode``: "onepass" (the one-program protocol, module docstring)
    runs the whole fold sweep as ONE compiled program — fold f is the
    weighted path with weight 0 on its held-out rows, vmapped over the
    fold axis; "loop" fits each training subset in a host-side fold
    loop; "auto" (default) picks onepass whenever a vmappable fold
    solver exists (the gaussian default and the GLM families) and falls
    back to the loop otherwise.  The two modes agree to solver
    tolerance (tested).

    ``weights``: observation weights (glmnet's ``weights`` in
    ``cv.glmnet``) — weight the full fit, every fold fit, and the
    cvm/cvsd aggregation.

    ``keep`` (glmnet's ``keep=TRUE``): return the (n, nlambda)
    prevalidated linear predictors — each row predicted by the fold fit
    that excluded it — in ``fit_preval`` (with ``foldid`` already a
    result field).

    ``type_measure`` (glmnet's ``type.measure``): 'default' scores by
    the family's deviance measure (MSE here); 'mse'/'mae' score on the
    response scale.  The GLM drivers (``cv_glm_path`` and friends)
    additionally accept 'deviance', and for binomial 'class'
    (misclassification) and 'auc' (per-fold Mann-Whitney; ``cvm`` is
    then the fold-weighted AUC and ``lambda_min`` MAXIMISES it).

    ``fold_mesh`` (via ``solver_kw``, onepass only): a
    ``jax.sharding.Mesh`` over which the FOLD axis of the one-pass
    sweep is sharded — CV folds are independent, so each device solves
    its folds' whole paths with only the batched while_loop's tiny
    all-done reduction crossing the mesh (nfolds must be a multiple of
    the mesh size).

    When an explicit ``foldid`` is given it defines the folds and
    ``nfolds`` is derived from it (glmnet convention).  Entries of -1
    (an extension; glmnet has no such sentinel) are excluded from CV
    scoring but still participate in EVERY fold's training set.
    """
    # X is NOT pulled to host here: a device-resident X flows straight
    # into the full fit and the one-pass fold sweep (zero re-uploads
    # through the host<->device link — at 10000x1000 the transfer, not
    # the solve, dominates CV wall time in this environment).  Only the
    # loop fallback needs host subsetting.
    n, p = np.shape(X)
    y = np.asarray(y, np.float64).ravel()
    if offset is not None:
        # glmnet's cv.glmnet offset (gaussian): an exact response shift
        # applies identically to every fold fit AND to the held-out
        # scoring residual y - (b0 + Xb + offset), so shifting y once
        # up front reproduces glmnet's cvm/cvsd exactly.
        if _family is not None or _loss_fn is not None:
            raise ValueError("offset= here is the gaussian response "
                             "shift; GLM CV drivers take their own "
                             "offset argument")
        off_g = np.asarray(offset, np.float64).ravel()
        if off_g.shape != y.shape:
            raise ValueError("offset must have one entry per row")
        y = y - off_g
    else:
        off_g = None
    w = None if weights is None else np.asarray(weights,
                                                np.float64).ravel()
    if w is not None and w.shape != (n,):
        raise ValueError("weights must have one entry per row")
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    # Cheap input validation BEFORE the expensive full-data fit; an
    # explicit foldid defines nfolds itself (glmnet convention).
    if foldid is None:
        if not 2 <= nfolds <= n:
            raise ValueError("nfolds must be in [2, nrow(x)]")
    else:
        foldid = np.asarray(foldid, np.int64)
        if foldid.shape != (n,):
            raise ValueError("foldid must have one entry per row")
        nfolds = int(foldid.max()) + 1
        counts = np.bincount(foldid[foldid >= 0], minlength=nfolds)
        if nfolds < 2 or np.any(counts == 0):
            raise ValueError(
                "foldid must assign at least one row to each of >= 2 "
                f"folds (got counts {counts.tolist()})")

    # Shared lambda grid: user-supplied, or from the full data (glmnet
    # convention).  ``lambdas`` is a named parameter so it cannot collide
    # with the per-fold calls' grid argument.
    is_default_path = _path_fn is None
    if is_default_path:
        path_solver_kw = {k: v for k, v in solver_kw.items()
                          if k != "fold_mesh"}

        def _path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                     lambda_min_ratio=lambda_min_ratio):
            return lasso_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              alpha=alpha, _enet_scale=_enet_scale,
                              standardize=standardize,
                              intercept=intercept, path_mode=path_mode,
                              weights=wf, **path_solver_kw)

        full = _path_fn(X, y, lambdas, w)
    else:
        if w is not None:
            if _fold_eta_fn is None:
                raise ValueError(
                    "weights are supported only for CV drivers with a "
                    "one-pass fold solver (gaussian / GLM families)")
            full = _path_fn(X, y, lambdas, w)
        else:
            full = _path_fn(X, y, lambdas)
    # The grid is pulled to host LAZILY: the one-pass sweep consumes the
    # device array directly, so the pull overlaps the sweep's compute
    # instead of stalling on the full fit (one fewer serialized host
    # round trip).
    lams_dev = full.lambdas
    lams = None

    if foldid is None:
        # glmnet: foldid = sample(rep(seq(nfolds), length = N)) — every
        # row gets a fold, sizes differ by at most one.
        rng = np.random.default_rng(seed)
        foldid = np.resize(np.arange(nfolds, dtype=np.int64), n)
        foldid = foldid[rng.permutation(n)]

    # Per-observation losses (glmnet's cvraw), each row scored by the
    # model trained without its fold; the loss maps the linear
    # predictor to the family's deviance measure (MSE for gaussian),
    # or to the glmnet ``type.measure`` alternative requested.
    loss, sense = _resolve_measure(
        type_measure, _family,
        (_loss_fn if _loss_fn is not None
         else _family.cv_loss if _family is not None
         else _squared_error))
    fold_eta = _fold_eta_fn
    if fold_eta is None and is_default_path and cv_mode != "loop":
        fold_eta = _make_gaussian_fold_eta(alpha, _enet_scale,
                                           standardize, intercept,
                                           solver_kw)
    if cv_mode == "onepass" and fold_eta is None:
        raise ValueError("cv_mode='onepass' needs a one-pass fold "
                         "solver; this CV driver has none — use "
                         "cv_mode='loop'")
    cvm = cvsd = eta_all = None
    if fold_eta is not None and cv_mode != "loop":
        # ONE compiled program for the whole fold sweep: fold f is the
        # weighted path with weight 0 on its held-out rows; predictions
        # for all n rows come back per fold and each row keeps its own
        # fold's (nlambda,) linear predictor.
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * w[None, :]
        eta_dev = fold_eta(X, y, lams_dev, masks,
                           np.clip(foldid, 0, None))
        # Default measures with keep=False: score ON DEVICE and ship
        # only the two (nlambda,) curves (see _score_reduce_dev) —
        # same glmnet formulas, float tolerance vs the host path
        # (tested).  Gaussian mse/mae always; GLM families whenever
        # they carry a JNP cv_loss twin (cv_loss_dev).
        dev_reduce = None
        if not keep and _loss_fn is None:
            if (_family is None
                    and type_measure in ("default", None, "mse", "mae")):
                kind = "mae" if type_measure == "mae" else "mse"
                dev_reduce = lambda e, yy, ws, ns: _score_reduce_dev(
                    e, yy, ws, ns, kind)
            elif (_family is not None
                  and type_measure in ("default", None, "deviance")
                  and getattr(_family, "cv_loss_dev", None) is not None):
                dev_reduce = _make_family_score_reduce(
                    _family.cv_loss_dev)
        if dev_reduce is not None:
            dt = eta_dev.dtype
            ws_np = (foldid >= 0).astype(np.float64)
            if w is not None:
                ws_np = ws_np * w
            curves = np.asarray(dev_reduce(
                eta_dev, jnp.asarray(y, dt), jnp.asarray(ws_np, dt),
                jnp.asarray(float((foldid >= 0).sum()), dt)),
                np.float64)
            cvm, cvsd = curves[0], curves[1]
        else:
            eta_all = np.asarray(eta_dev)
        lams = np.asarray(lams_dev, np.float64)
    else:
        lams = np.asarray(lams_dev, np.float64)
        if w is not None and not (is_default_path
                                  or _fold_eta_fn is not None):
            raise ValueError("weighted CV is not supported for this "
                             "driver (its path solver takes no weights)")
        X_np = np.asarray(X, np.float64)
        eta_all = np.full((n, lams.shape[0]), np.nan)
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            res = (_path_fn(X_np[tr], y[tr], lams, w[tr])
                   if w is not None else _path_fn(X_np[tr], y[tr], lams))
            eta_all[va] = (np.asarray(res.beta0)[:, None]
                           + np.asarray(res.coef) @ X_np[va].T).T

    scored = foldid >= 0
    n_sc = int(scored.sum())
    if cvm is not None:
        pass  # scored on device above (one-pass gaussian mse/mae)
    elif loss == "auc":
        # Per-FOLD measure (glmnet): cvraw is (nfolds, L) fold AUCs
        # aggregated with fold sample weights, and "better" is LARGER.
        cvraw, fold_w = _fold_auc(eta_all, y, foldid, nfolds, w)
        fw = fold_w / fold_w.sum()
        cvm = fw @ cvraw
        nf_eff = int((fold_w > 0).sum())
        cvsd = np.sqrt((fw @ (cvraw - cvm) ** 2)
                       / max(nf_eff - 1, 1))
    else:
        sqerr = loss(eta_all.T, y).T           # eta_all is (n, nlambda)
        if w is None:
            cvm = sqerr[scored].mean(axis=0)
            # glmnet: cvsd = sqrt(weighted.mean((cvraw-cvm)^2) / (N-1))
            cvsd = np.sqrt(((sqerr[scored] - cvm) ** 2).mean(axis=0)
                           / (n_sc - 1))
        else:
            # glmnet's weighted cvm/cvsd (weighted.mean over scored rows).
            ws = w[scored]
            cvm = (ws[:, None] * sqerr[scored]).sum(axis=0) / ws.sum()
            cvsd = np.sqrt((ws[:, None] * (sqerr[scored] - cvm) ** 2)
                           .sum(axis=0) / ws.sum() / (n_sc - 1))
    if sense == "max":
        i_min = int(np.argmax(cvm))
        within = cvm >= cvm[i_min] - cvsd[i_min]
    else:
        i_min = int(np.argmin(cvm))
        within = cvm <= cvm[i_min] + cvsd[i_min]
    lambda_min = float(lams[i_min])
    lambda_1se = float(lams[np.flatnonzero(within)[0]])  # grid is decreasing

    if keep and off_g is not None:
        # glmnet's buildPredmat: the prevalidated predictors carry the
        # offset (the fits ran on y - offset; scoring fit_preval
        # against the ORIGINAL y must reproduce cvm).
        eta_all = eta_all + off_g[:, None]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=lambda_min, lambda_1se=lambda_1se,
                    fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)


def cv_enet_path(X, y, *, alpha: float = 1.0, **kw) -> CVResult:
    """Cross-validated Elastic-Net path (lambda0 inflation as in
    reference: src/ADMMEnet.h:56)."""
    return cv_lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def cv_group_lasso_path(X, y, groups, *, weights=None, nlambda: int = 100,
                        lambda_min_ratio: Optional[float] = None,
                        standardize: bool = True, intercept: bool = True,
                        maxit: int = 10000, eps_abs: float = 1e-5,
                        eps_rel: float = 1e-5, rho: float = -1.0,
                        obs_weights=None, l1_ratio: float = 0.0,
                        **kw) -> CVResult:
    """Cross-validated (sparse-)group-Lasso path (extension; same fold
    protocol as :func:`cv_lasso_path`, one-pass fold sweep by default).
    ``weights`` are the GROUP penalty weights; ``obs_weights`` the
    observation weights (the group path's naming).  Solver options are
    named explicitly so they reach the group solver (generic **kw
    would be consumed by the lasso path this wraps)."""
    from .grouplasso import group_lasso_path, normalize_groups

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return group_lasso_path(Xf, yf, groups, weights=weights,
                                lambdas=lambdas, nlambda=nlambda,
                                lambda_min_ratio=lambda_min_ratio,
                                standardize=standardize,
                                intercept=intercept, maxit=maxit,
                                eps_abs=eps_abs, eps_rel=eps_rel,
                                rho=rho, obs_weights=wf,
                                l1_ratio=l1_ratio)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        p = np.shape(Xf)[1]
        gj, gw = normalize_groups(groups, p, weights, dtype)
        return _group_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype), gj, gw,
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32), rho, maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept,
            l1_ratio=float(l1_ratio))

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         weights=obs_weights,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta, **kw)


def cv_logistic_path(X, y, **kw) -> CVResult:
    """Cross-validated sparse logistic regression path (extension; same
    fold protocol as :func:`cv_lasso_path`, scored by per-observation
    BINOMIAL DEVIANCE — glmnet's default type.measure for
    family='binomial', here the family's own default loss so the
    device-side score reduction applies).  The binomial case of
    :func:`cv_glm_path`."""
    from .glm import binomial

    return cv_glm_path(X, y, binomial(), **kw)


def cv_glm_path(X, y, family, *, nlambda: int = 50,
                lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
                standardize: bool = True, intercept: bool = True,
                maxit: int = 10000, eps_abs: float = 1e-5,
                eps_rel: float = 1e-5, rho: float = -1.0,
                path_mode: str = "auto", loss=None,
                newton_steps: Optional[int] = None,
                penalty_factor=None, lower_limits=None,
                upper_limits=None, exclude=None, offset=None,
                **kw) -> CVResult:
    """Cross-validated path for any smooth-loss GLM family (extension;
    admm_tpu/models/glm.py).  Held-out folds are scored by the FAMILY'S
    per-observation loss evaluated at the linear predictor — i.e. the
    deviance-style measure matching the objective being fit — unless an
    explicit ``loss(eta, y)`` is given.  ``cv_logistic_path`` is the
    binomial special case.  The fold sweep runs as one compiled program
    by default (``cv_mode`` as in :func:`cv_lasso_path`); observation
    ``weights`` are supported (weighted fits + weighted cvm/cvsd).
    ``type_measure`` selects glmnet's alternative measures
    ('deviance'/'mse'/'mae', plus 'class'/'auc' for binomial — see
    :func:`cv_lasso_path`)."""
    from .glm import GLMFamily, glm_lasso_path

    fam = family() if not isinstance(family, GLMFamily) else family
    # loss=None stays None: cv_lasso_path defaults to the family's
    # cv_loss and can then score ON DEVICE via cv_loss_dev (an explicit
    # user loss forces the host path).
    if offset is not None and kw.get("cv_mode") == "loop":
        # The host fold loop subsets rows; only the one-pass sweep
        # threads the full offset vector through every fold fit.
        raise ValueError("offset with cv_mode='loop' is not supported; "
                         "use the default one-pass fold sweep")

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return glm_lasso_path(Xf, yf, fam, lambdas=lambdas,
                              nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              alpha=alpha, standardize=standardize,
                              intercept=intercept, maxit=maxit,
                              eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                              path_mode=path_mode, weights=wf,
                              offset=offset,
                              penalty_factor=penalty_factor,
                              lower_limits=lower_limits,
                              upper_limits=upper_limits,
                              exclude=exclude,
                              newton_steps=_default_newton_steps(
                                  fam, newton_steps))

    fold_eta = _make_glm_fold_eta(fam, alpha, standardize, intercept,
                                  maxit, eps_abs, eps_rel, rho,
                                  path_mode,
                                  fold_mesh=kw.get("fold_mesh"),
                                  newton_steps=newton_steps,
                                  penalty_factor=penalty_factor,
                                  lower_limits=lower_limits,
                                  upper_limits=upper_limits,
                                  exclude=exclude, offset=offset)
    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _loss_fn=loss,
                         _fold_eta_fn=fold_eta, _family=fam, **kw)


def cv_dantzig_path(X, y, *, nlambda: int = 100,
                    lambda_min_ratio: Optional[float] = None,
                    standardize: bool = True, intercept: bool = True,
                    maxit: int = 10000, eps_abs: float = 1e-5,
                    eps_rel: float = 1e-5, rho: float = -1.0,
                    path_mode: str = "batch", **kw) -> CVResult:
    """Cross-validated Dantzig-selector path (extension; same fold
    protocol as :func:`cv_lasso_path`, scored by held-out MSE,
    one-pass fold sweep by default over the weighted engine)."""
    from .dantzig import dantzig_path

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return dantzig_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                            lambda_min_ratio=lambda_min_ratio,
                            standardize=standardize, intercept=intercept,
                            maxit=maxit, eps_abs=eps_abs,
                            eps_rel=eps_rel, rho=rho,
                            path_mode=path_mode, weights=wf)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        return _dz_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32), rho, maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept,
            path_mode="batch")

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta, **kw)


def cv_gen_lasso_path(X, y, D, *, nlambda: int = 50,
                      lambda_min_ratio: float = 1e-3,
                      intercept: bool = True, maxit: int = 10000,
                      eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                      rho: float = -1.0, path_mode: str = "batch",
                      **kw) -> CVResult:
    """Cross-validated generalized-Lasso path (extension): selects
    lambda for an arbitrary (m, p) structure matrix ``D`` (fused lasso,
    trend filtering) by held-out MSE; same fold protocol as
    :func:`cv_lasso_path`, one-pass fold sweep by default."""
    from .genlasso import gen_lasso_path

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return gen_lasso_path(Xf, yf, D, lambdas=lambdas,
                              nlambda=nlambda,
                              lambda_min_ratio=lambda_min_ratio,
                              intercept=intercept, maxit=maxit,
                              eps_abs=eps_abs, eps_rel=eps_rel, rho=rho,
                              path_mode=path_mode, weights=wf)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        return _gen_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype),
            jnp.asarray(D, dtype), jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32),
            rho, maxit, eps_abs, eps_rel, intercept=intercept)

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         intercept=intercept, _path_fn=path_fn,
                         _fold_eta_fn=fold_eta, **kw)


def cv_fused_lasso_path(X, y, *, order: int = 1, **kw) -> CVResult:
    """Cross-validated fused lasso / trend filtering (the generalized
    Lasso with the discrete difference operator)."""
    from .genlasso import difference_matrix

    p = np.asarray(np.shape(X))[1]
    return cv_gen_lasso_path(X, y, difference_matrix(int(p), order),
                             **kw)


def _cv_foldid(n, nfolds, seed, foldid):
    """Shared fold-assignment resolution (glmnet conventions, -1
    sentinel supported) for the standalone multi-output CV drivers."""
    if foldid is None:
        if not 2 <= nfolds <= n:
            raise ValueError("nfolds must be in [2, nrow(x)]")
        rng = np.random.default_rng(seed)
        foldid = np.resize(np.arange(nfolds, dtype=np.int64), n)
        foldid = foldid[rng.permutation(n)]
    else:
        foldid = np.asarray(foldid, np.int64)
        if foldid.shape != (n,):
            raise ValueError("foldid must have one entry per row")
        nfolds = int(foldid.max()) + 1
        counts = np.bincount(foldid[foldid >= 0], minlength=nfolds)
        if nfolds < 2 or np.any(counts == 0):
            raise ValueError("foldid must assign at least one row to "
                             "each of >= 2 folds")
    return foldid, nfolds


def _cv_curve(per_obs, foldid, w=None):
    """cvm/cvsd/lambda_min/lambda_1se from an (n, nlambda)
    per-observation loss matrix (glmnet aggregation; optional
    observation weights as in cv_lasso_path)."""
    scored = foldid >= 0
    n_sc = int(scored.sum())
    if w is None:
        cvm = per_obs[scored].mean(axis=0)
        cvsd = np.sqrt(((per_obs[scored] - cvm) ** 2).mean(axis=0)
                       / (n_sc - 1))
    else:
        ws = np.asarray(w, np.float64).ravel()[scored]
        cvm = (ws[:, None] * per_obs[scored]).sum(axis=0) / ws.sum()
        cvsd = np.sqrt((ws[:, None] * (per_obs[scored] - cvm) ** 2)
                       .sum(axis=0) / ws.sum() / (n_sc - 1))
    return cvm, cvsd


def cv_multinomial_path(X, y, *, nfolds: int = 10, seed: int = 0,
                        foldid: Optional[np.ndarray] = None,
                        nlambda: int = 50,
                        type_measure: str = "deviance",
                        cv_mode: str = "auto", keep: bool = False,
                        **path_kw) -> CVResult:
    """Cross-validated sparse multinomial path (extension), scored by
    per-observation MULTINOMIAL DEVIANCE ``-2 log p_{i, y_i}``
    (glmnet's type.measure="deviance" for family="multinomial") —
    or by glmnet's alternatives: ``type_measure`` 'class'
    (misclassification of the argmax), 'mse'/'mae' (over the C
    class-indicator/probability differences).  ``path_kw`` forwards to
    :func:`admm_tpu.models.multinomial.multinomial_lasso_path`; the
    ``fit`` field holds the full-data MNPathResult.

    ``cv_mode``: "onepass" (the default via "auto") runs the whole
    fold sweep as ONE compiled program — fold f is the weighted path
    with weight 0 on its held-out rows, vmapped (the gaussian/GLM
    protocol, :mod:`admm_tpu.models.cv` docstring); "loop" refits per
    fold on the host.  Equal to solver tolerance (tested)."""
    from .multinomial import multinomial_lasso_path

    if type_measure not in ("deviance", "default", "class", "mse",
                            "mae"):
        raise ValueError("multinomial type_measure must be 'deviance',"
                         " 'class', 'mse' or 'mae'")
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    X = np.asarray(X, np.float64)
    y = np.asarray(y).ravel().astype(np.int64)
    n = X.shape[0]
    C = int(y.max()) + 1
    path_kw.setdefault("nclass", C)
    # glmnet's cv offset (multinomial): (n, C), subset per fold and
    # added back to the held-out linear predictors before scoring.
    off = path_kw.pop("offset", None)
    if off is not None:
        off = np.asarray(off, np.float64)
        if off.shape != (n, C):
            raise ValueError("offset must be (n, nclass)")
    w = path_kw.pop("weights", None)
    w = None if w is None else np.asarray(w, np.float64).ravel()
    fold_mesh = path_kw.pop("fold_mesh", None)
    full = multinomial_lasso_path(X, y, nlambda=nlambda, offset=off,
                                  weights=w, **path_kw)
    path_kw.pop("lambdas", None)   # fold refits get the shared grid
    lams = np.asarray(full.lambdas, np.float64)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    onepass = cv_mode != "loop" and not any(
        path_kw.get(k) is not None for k in ("trace_len", "data_mesh"))
    if cv_mode == "onepass" and not onepass:
        raise ValueError("cv_mode='onepass' does not support "
                         "trace_len/data_mesh")
    eta_all = np.full((n, lams.shape[0], C), np.nan)
    if onepass:
        from .lasso import validate_pf_limits
        from .multitask import _keep_mask

        dtype = path_kw.get("dtype", jnp.float32)
        pf, _ = validate_pf_limits(path_kw.get("penalty_factor"), None,
                                   None, None, X.shape[1], dtype)
        keep_p = _keep_mask(path_kw.get("exclude"), X.shape[1], dtype)
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * w[None, :]
        eta_all = np.asarray(_mn_fold_etas(
            jnp.asarray(X, dtype), jnp.asarray(y),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(np.clip(foldid, 0, None), jnp.int32),
            path_kw.get("rho", -1.0), path_kw.get("maxit", 10000),
            path_kw.get("eps_abs", 1e-5), path_kw.get("eps_rel", 1e-5),
            path_kw.get("alpha", 1.0), pf, keep_p,
            None if off is None else jnp.asarray(off, dtype),
            nclass=C,
            standardize_x=path_kw.get("standardize", True),
            intercept=path_kw.get("intercept", True),
            grouped=bool(path_kw.get("grouped", False)),
            newton_steps=int(path_kw.get("newton_steps", 2))),
            np.float64)                           # (n, L, C)
    else:
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            res = multinomial_lasso_path(
                X[tr], y[tr], lambdas=lams,
                weights=None if w is None else w[tr],
                offset=None if off is None else off[tr], **path_kw)
            eta = (np.asarray(res.beta0)[:, None, :]
                   + np.einsum("vp,lpc->lvc", X[va],
                               np.asarray(res.coef)))
            if off is not None:
                eta = eta + off[va][None, :, :]
            eta_all[va] = np.moveaxis(eta, 0, 1)  # (n_va, L, C)

    # Stable log-softmax scoring over ALL scored rows at once.
    scored = foldid >= 0
    ev = eta_all[scored]                          # (m, L, C)
    ev = ev - ev.max(axis=2, keepdims=True)
    logp = ev - np.log(np.exp(ev).sum(axis=2, keepdims=True))
    ys = y[scored]
    dev = np.full((n, lams.shape[0]), np.nan)
    if type_measure == "class":
        dev[scored] = (np.argmax(logp, axis=2)
                       != ys[:, None]).astype(float)
    elif type_measure in ("mse", "mae"):
        p_ = np.exp(logp)                         # (m, L, C)
        ind = np.zeros((ys.size, C))
        ind[np.arange(ys.size), ys] = 1.0
        d = p_ - ind[:, None, :]
        dev[scored] = (np.abs(d).sum(axis=2) if type_measure == "mae"
                       else (d ** 2).sum(axis=2))
    else:
        dev[scored] = -2.0 * logp[np.arange(ys.size), :, ys]

    cvm, cvsd = _cv_curve(dev, foldid, w)
    i_min = int(np.argmin(cvm))
    within = cvm <= cvm[i_min] + cvsd[i_min]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=float(lams[i_min]),
                    lambda_1se=float(lams[np.flatnonzero(within)[0]]),
                    fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)


def cv_multitask_lasso_path(X, Y, *, nfolds: int = 10, seed: int = 0,
                            foldid: Optional[np.ndarray] = None,
                            nlambda: int = 50, cv_mode: str = "auto",
                            keep: bool = False,
                            **path_kw) -> CVResult:
    """Cross-validated multi-task Lasso path (extension), scored by the
    per-observation squared error SUMMED OVER TASKS (the Frobenius
    analog of the gaussian MSE).  ``path_kw`` forwards to
    :func:`admm_tpu.models.multitask.multitask_lasso_path`.

    ``cv_mode``: "onepass" (the default via "auto") runs the whole
    fold sweep as ONE compiled program — folds as weight-zero lanes,
    vmapped (the gaussian/GLM protocol); "loop" refits per fold on the
    host.  Equal to solver tolerance (tested)."""
    from .multitask import multitask_lasso_path

    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    n = X.shape[0]
    # glmnet's cv offset (mgaussian): (n, K) response shift, subset per
    # fold; held-out scoring adds it back (= scoring Y - off shifts).
    off = path_kw.pop("offset", None)
    if off is not None:
        off = np.asarray(off, np.float64)
        if off.shape != Y.shape:
            raise ValueError("offset must match Y's (n, K) shape")
    w = path_kw.pop("weights", None)
    w = None if w is None else np.asarray(w, np.float64).ravel()
    fold_mesh = path_kw.pop("fold_mesh", None)
    full = multitask_lasso_path(X, Y, nlambda=nlambda, offset=off,
                                weights=w, **path_kw)
    path_kw.pop("lambdas", None)   # fold refits get the shared grid
    lams = np.asarray(full.lambdas, np.float64)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    onepass = cv_mode != "loop" and not any(
        path_kw.get(k) is not None for k in ("trace_len", "data_mesh"))
    if cv_mode == "onepass" and not onepass:
        raise ValueError("cv_mode='onepass' does not support "
                         "trace_len/data_mesh")
    err = np.full((n, lams.shape[0]), np.nan)
    eta_all = np.full((n, lams.shape[0], Y.shape[1]), np.nan)
    Yf = Y if off is None else Y - off          # fits see shifted Y
    if onepass:
        from .lasso import validate_pf_limits
        from .multitask import _keep_mask

        dtype = path_kw.get("dtype", jnp.float32)
        pf, _ = validate_pf_limits(path_kw.get("penalty_factor"), None,
                                   None, None, X.shape[1], dtype)
        keep_m = _keep_mask(path_kw.get("exclude"), X.shape[1], dtype)
        masks = (foldid[None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        if w is not None:
            masks = masks * w[None, :]
        eta_all = np.asarray(_mt_fold_etas(
            jnp.asarray(X, dtype), jnp.asarray(Yf, dtype),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(np.clip(foldid, 0, None), jnp.int32),
            path_kw.get("rho", -1.0), path_kw.get("maxit", 10000),
            path_kw.get("eps_abs", 1e-5), path_kw.get("eps_rel", 1e-5),
            pf, keep_m, path_kw.get("alpha", 1.0),
            standardize_x=path_kw.get("standardize", True),
            intercept=path_kw.get("intercept", True),
            standardize_y=bool(path_kw.get("standardize_response",
                                           False)),
            penalty=path_kw.get("penalty", "rows")),
            np.float64)                          # (n, L, K)
        if off is not None:
            eta_all = eta_all + off[:, None, :]
        err = ((eta_all - Y[:, None, :]) ** 2).sum(axis=2)
    else:
        for f in range(nfolds):
            tr = foldid != f
            va = foldid == f
            res = multitask_lasso_path(
                X[tr], Y[tr], lambdas=lams,
                weights=None if w is None else w[tr],
                offset=None if off is None else off[tr], **path_kw)
            pred = (np.asarray(res.beta0)[:, None, :]
                    + np.einsum("vp,lpk->lvk", X[va],
                                np.asarray(res.coef)))  # (L, n_va, K)
            if off is not None:
                pred = pred + off[va][None, :, :]
            eta_all[va] = np.moveaxis(pred, 0, 1)
            err[va] = ((pred - Y[va][None]) ** 2).sum(axis=2).T

    cvm, cvsd = _cv_curve(err, foldid, w)
    i_min = int(np.argmin(cvm))
    within = cvm <= cvm[i_min] + cvsd[i_min]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=float(lams[i_min]),
                    lambda_1se=float(lams[np.flatnonzero(within)[0]]),
                    fit=full, foldid=foldid,
                    fit_preval=eta_all if keep else None)


def cv_slope_path(X, y, *, lam_seq=None, q: float = 0.1,
                  nlambda: int = 30, lambda_min_ratio: float = 1e-2,
                  standardize: bool = True, intercept: bool = True,
                  maxit: int = 10000, eps_abs: float = 1e-5,
                  eps_rel: float = 1e-5, rho: float = -1.0,
                  **kw) -> CVResult:
    """Cross-validated SLOPE path over the sequence SCALE t (extension;
    admm_tpu/models/slope.py): the sorted-l1 sequence (BH at level
    ``q`` by default) is fixed, the CV selects its multiplier — the
    glmnet protocol with t in the lambda role.  One-pass fold sweep by
    default (fold-as-lane weights), weighted CV and ``fold_mesh``
    supported."""
    from .slope import _slope_fold_etas, bh_sequence, slope_path

    p = np.shape(X)[1]
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    lam_np = np.asarray(lam_seq, np.float64).ravel()

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return slope_path(Xf, yf, lam_seq=lam_np, lambdas=lambdas,
                          nlambda=nlambda,
                          lambda_min_ratio=lambda_min_ratio,
                          standardize=standardize, intercept=intercept,
                          weights=wf, maxit=maxit, eps_abs=eps_abs,
                          eps_rel=eps_rel, rho=rho)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        return _slope_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype),
            jnp.asarray(lam_np, dtype), jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32), rho, maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept)

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta, **kw)


def cv_sqrt_lasso_path(X, y, *, nlambda: int = 30,
                       lambda_min_ratio: float = 1e-2,
                       standardize: bool = True, intercept: bool = True,
                       maxit: int = 10000, eps_abs: float = 1e-6,
                       eps_rel: float = 1e-6, rho: float = -1.0,
                       **kw) -> CVResult:
    """Cross-validated square-root-lasso path (extension;
    admm_tpu/models/sqrtlasso.py): MSE-scored with the glmnet fold
    protocol; one-pass fold sweep by default (weight-0 held-out rows
    drop out of the weighted l2-norm loss exactly)."""
    from .sqrtlasso import _sqrt_fold_etas, sqrt_lasso_path

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return sqrt_lasso_path(Xf, yf, lambdas=lambdas, nlambda=nlambda,
                               lambda_min_ratio=lambda_min_ratio,
                               standardize=standardize,
                               intercept=intercept, weights=wf,
                               maxit=maxit, eps_abs=eps_abs,
                               eps_rel=eps_rel, rho=rho)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        return _sqrt_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32), rho, maxit, eps_abs, eps_rel,
            standardize_x=standardize, intercept=intercept)

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         standardize=standardize, intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta, **kw)


def cv_constrained_lasso_path(X, y, C, d=None, *, nlambda: int = 50,
                              lambda_min_ratio: float = 1e-3,
                              intercept: bool = True,
                              maxit: int = 10000,
                              eps_abs: float = 1e-5,
                              eps_rel: float = 1e-5, rho: float = -1.0,
                              **kw) -> CVResult:
    """Cross-validated equality-constrained lasso path (extension;
    admm_tpu/models/conlasso.py) — every fold fit honors ``C b = d``;
    one-pass fold sweep by default."""
    from .conlasso import _conlasso_fold_etas, constrained_lasso_path

    p = np.shape(X)[1]
    C_j = jnp.atleast_2d(jnp.asarray(C, jnp.float32))
    d_j = (jnp.zeros((C_j.shape[0],), jnp.float32) if d is None
           else jnp.asarray(d, jnp.float32).ravel())

    def path_fn(Xf, yf, lambdas, wf=None, nlambda=nlambda,
                lambda_min_ratio=lambda_min_ratio):
        return constrained_lasso_path(
            Xf, yf, C, d, lambdas=lambdas, nlambda=nlambda,
            lambda_min_ratio=lambda_min_ratio, intercept=intercept,
            weights=wf, maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel,
            rho=rho)

    fold_mesh = kw.get("fold_mesh")

    def fold_eta(Xf, yf, lams, masks, fid, dtype=jnp.float32):
        return _conlasso_fold_etas(
            jnp.asarray(Xf, dtype), jnp.asarray(yf, dtype),
            jnp.asarray(C_j, dtype), jnp.asarray(d_j, dtype),
            jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            jnp.asarray(fid, jnp.int32), rho, maxit, eps_abs, eps_rel,
            intercept=intercept)

    return cv_lasso_path(X, y, nlambda=nlambda,
                         lambda_min_ratio=lambda_min_ratio,
                         intercept=intercept,
                         _path_fn=path_fn, _fold_eta_fn=fold_eta, **kw)


def cv_zerosum_lasso_path(X, y, **kw) -> CVResult:
    """Cross-validated zero-sum lasso (the one-row constrained case)."""
    p = np.shape(X)[1]
    return cv_constrained_lasso_path(X, y, np.ones((1, p)), **kw)
