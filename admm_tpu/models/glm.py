"""Penalized GLM-style smooth-loss paths by ADMM: the family core.

Extension beyond the reference (gaussian-only): one inexact-Newton ADMM
engine serves every model of the form ::

    minimize  1/n sum_i loss(eta_i; y_i)
              + lambda (alpha ||b||_1 + (1-alpha)/2 ||b||_2^2),
    eta = b0 + X b

where ``loss`` is smooth (or semi-smooth) in the linear predictor eta.
A family supplies two per-observation callables — ``grad_eta`` (dloss/
deta) and ``weight_eta`` (d2loss/deta2, the IRLS weight) — plus the
null-model gradient used for the glmnet lambda_max rule.  Shipped
families:

* ``binomial()``  — sparse logistic regression (models/logistic.py
  wraps this; oracle: sklearn saga, tests/test_logistic.py)
* ``huber(M)``    — robust regression with the Huber loss (the smooth
  bridge between the reference's gaussian Lasso and its LAD); as
  M -> inf it reduces EXACTLY to the gaussian Lasso objective (tested)
* ``poisson()``   — log-linear count regression

ADMM splitting ``b - z = 0`` with f = the smooth loss and g = the
penalty; the x-update is a fixed-step damped Newton solve (one (q, q)
Hessian build + Cholesky per step) warm-started from the previous
iterate, the z-update a masked elastic-net prox with the intercept
unpenalized (see models/logistic.py's module docstring for the
engineering details this generalizes).
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (ProblemOps, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import dot
from .lasso import PathResult, _batched_cold_states, _scan_path

_NEWTON_STEPS = 2


def _poisson_deviance(eta, y):
    """Per-observation Poisson deviance from the linear predictor
    (numpy; the y log y term follows xlogy semantics: 0 at y = 0)."""
    mu = np.exp(np.minimum(eta, 30.0))
    ylogy = np.where(y > 0, y * np.log(np.maximum(y, 1e-12)),
                     0.0)[None, :]
    return 2.0 * (ylogy - y[None, :] * eta - (y[None, :] - mu))


def _poisson_deviance_dev(eta, y):
    """JNP twin of :func:`_poisson_deviance` (device-side CV scoring)."""
    mu = jnp.exp(jnp.minimum(eta, 30.0))
    ylogy = jnp.where(y > 0, y * jnp.log(jnp.maximum(y, 1e-12)),
                      0.0)[None, :]
    return 2.0 * (ylogy - y[None, :] * eta - (y[None, :] - mu))


def _wmean(y, w=None):
    """Weighted mean (plain mean when ``w`` is None)."""
    if w is None:
        return jnp.mean(y)
    return jnp.sum(w * y) / jnp.sum(w)


class GLMFamily(NamedTuple):
    """Per-observation derivatives of the loss in the linear predictor.

    ``grad_eta(eta, y)`` = dloss/deta, ``weight_eta(eta, y)`` =
    d2loss/deta2 (the IRLS weight), ``null_resid(y, intercept, w=None)``
    = the null-model -grad used by the lambda_max rule (``w`` =
    observation weights: the null intercept becomes the WEIGHTED
    location estimate, so the weighted grid top still nulls the
    model)."""
    name: str
    grad_eta: Callable
    weight_eta: Callable
    null_resid: Callable
    # Per-observation CV loss loss(eta (k, n), y (n,)) -> (k, n) in
    # numpy — the deviance-style measure matching the objective
    # (models/cv.py::cv_glm_path scores held-out folds with it).
    cv_loss: Callable
    # Global upper bound on weight_eta (d2loss/deta2), or None when the
    # curvature is unbounded (poisson).  Bounded-curvature families get
    # the FIXED-MAJORIZER x-update: H_fix = bound * X'WX/n >= H(b) for
    # every b, factorized ONCE per path like the gaussian tall solver's
    # ridge inverse — each inner step is then two thin matvecs instead
    # of an (n, q, q) Hessian build + Cholesky (DESIGN.md "GLM tier").
    curvature_bound: Optional[float] = None
    # Scalar family parameter (huber's M), exposed so non-closure
    # consumers (the checkpoint model tag) can tell families apart.
    param: float = 0.0
    # Inverse link mu(eta) in NUMPY (host-side, like cv_loss): feeds
    # predict(type="response")/assess mse/mae for family objects.
    # None = identity (gaussian-style location families, e.g. huber).
    mean_eta: Optional[Callable] = None
    # Optional JNP twin of cv_loss: when present, the one-pass CV's
    # default-deviance scoring reduces cvm/cvsd ON DEVICE and only two
    # (nlambda,) curves cross the host link (the round-5 roofline fix,
    # DESIGN.md "Roofline"; models/cv.py::_make_family_score_reduce).
    # None falls back to host numpy scoring.
    cv_loss_dev: Optional[Callable] = None


@lru_cache(maxsize=None)
def binomial() -> GLMFamily:
    """Logistic loss: loss(eta; y) = log(1 + e^eta) - y eta."""
    return GLMFamily(
        name="binomial",
        grad_eta=lambda eta, y: jax.nn.sigmoid(eta) - y,
        weight_eta=lambda eta, y: (lambda p: p * (1.0 - p))(
            jax.nn.sigmoid(eta)),
        null_resid=lambda y, intercept, w=None: y - (
            _wmean(y, w) if intercept else 0.5),
        cv_loss=lambda eta, y: 2.0 * (np.logaddexp(0.0, eta)
                                      - y[None, :] * eta),
        cv_loss_dev=lambda eta, y: 2.0 * (jnp.logaddexp(0.0, eta)
                                          - y[None, :] * eta),
        curvature_bound=0.25,  # p(1-p) <= 1/4
        mean_eta=lambda eta: 1.0 / (1.0 + np.exp(-eta)),
    )


@lru_cache(maxsize=None)
def huber(M: float = 1.345) -> GLMFamily:
    """Huber loss in the residual r = y - eta: r^2/2 for |r| <= M, else
    M|r| - M^2/2.  Semi-smooth: the IRLS weight is the indicator
    |r| <= M (the rho-regularized Newton Hessian stays PD).  M -> inf
    recovers the gaussian Lasso objective exactly."""

    def null_resid(y, intercept, w=None):
        if not intercept:
            return jnp.clip(y, -M, M)
        # The null intercept is the (weighted) HUBER location M-estimate
        # (the root of sum w clip(y - mu, -M, M) = 0), NOT the mean:
        # with asymmetric contamination — exactly the regime this loss
        # targets — the mean-anchored grid top would not null the model.
        # The score is monotone nonincreasing in mu and changes sign on
        # [min(y), max(y)], so plain BISECTION is globally convergent —
        # the earlier undamped Newton stalled when the inlier window
        # emptied under extreme contamination (advisor finding r2).
        # 60 halvings of the bracket are past f32 AND f64 resolution.
        def score(mu):
            r = jnp.clip(y - mu, -M, M)
            return jnp.sum(r if w is None else w * r)

        def step(_, ab):
            lo, hi = ab
            mid = 0.5 * (lo + hi)
            pos = score(mid) > 0  # root is above mid
            return (jnp.where(pos, mid, lo), jnp.where(pos, hi, mid))

        lo, hi = jax.lax.fori_loop(0, 60, step,
                                   (jnp.min(y), jnp.max(y)))
        mu = 0.5 * (lo + hi)
        return jnp.clip(y - mu, -M, M)

    def cv_loss(eta, y):
        r = np.abs(y[None, :] - eta)
        return np.where(r <= M, 0.5 * r * r, M * r - 0.5 * M * M)

    def cv_loss_dev(eta, y):
        r = jnp.abs(y[None, :] - eta)
        return jnp.where(r <= M, 0.5 * r * r, M * r - 0.5 * M * M)

    return GLMFamily(
        name="huber",
        grad_eta=lambda eta, y: -jnp.clip(y - eta, -M, M),
        weight_eta=lambda eta, y: (jnp.abs(y - eta) <= M).astype(
            eta.dtype),
        null_resid=null_resid,
        cv_loss=cv_loss,
        cv_loss_dev=cv_loss_dev,
        curvature_bound=1.0,  # the inlier indicator is <= 1
        param=float(M),
    )


@lru_cache(maxsize=None)
def poisson() -> GLMFamily:
    """Poisson log-likelihood: loss(eta; y) = e^eta - y eta (eta clipped
    at 30 so a transient Newton overshoot cannot overflow f32)."""
    return GLMFamily(
        name="poisson",
        grad_eta=lambda eta, y: jnp.exp(jnp.minimum(eta, 30.0)) - y,
        weight_eta=lambda eta, y: jnp.exp(jnp.minimum(eta, 30.0)),
        null_resid=lambda y, intercept, w=None: y - (
            _wmean(y, w) if intercept else 1.0),
        cv_loss=_poisson_deviance,
        cv_loss_dev=_poisson_deviance_dev,
        mean_eta=lambda eta: np.exp(np.minimum(eta, 30.0)),
    )


def _mills(eta):
    """Inverse Mills ratio phi(eta)/Phi(eta), stable for any eta via
    the log-cdf (never forms the catastrophic phi/Phi quotient)."""
    from jax.scipy.stats import norm

    return jnp.exp(norm.logpdf(eta) - norm.logcdf(eta))


def _probit_mean(eta):
    from scipy.special import ndtr

    return ndtr(eta)


@lru_cache(maxsize=None)
def binomial_probit() -> GLMFamily:
    """Binomial with the PROBIT link (glmnet 4.x's
    ``family = binomial(link = "probit")`` family-object path):
    loss(eta; y) = -[y log Phi(eta) + (1-y) log Phi(-eta)].

    With r1 = phi/Phi(eta) and r0 = phi/Phi(-eta) (inverse Mills
    ratios, computed in log space), dloss/deta = (1-y) r0 - y r1 and
    d2loss/deta2 = y r1 (r1 + eta) + (1-y) r0 (r0 - eta) — both terms
    lie in (0, 1), so the curvature bound 1 drives the same
    fixed-majorizer protocol as the logit link."""
    def cv_loss(eta, y):
        from scipy.special import log_ndtr

        return -2.0 * (y[None, :] * log_ndtr(eta)
                       + (1.0 - y[None, :]) * log_ndtr(-eta))

    def null_resid(y, intercept, w=None):
        from jax.scipy.special import ndtri

        pbar = _wmean(y, w) if intercept else jnp.asarray(0.5, y.dtype)
        eta0 = ndtri(jnp.clip(pbar, 1e-6, 1.0 - 1e-6)).astype(y.dtype)
        r1, r0 = _mills(eta0), _mills(-eta0)
        return y * r1 - (1.0 - y) * r0

    return GLMFamily(
        name="binomial_probit",
        grad_eta=lambda eta, y: ((1.0 - y) * _mills(-eta)
                                 - y * _mills(eta)),
        weight_eta=lambda eta, y: (
            y * (lambda r: r * (r + eta))(_mills(eta))
            + (1.0 - y) * (lambda r: r * (r - eta))(_mills(-eta))),
        null_resid=null_resid,
        cv_loss=cv_loss,
        curvature_bound=1.0,  # r(r +/- eta) < 1 for every eta
        mean_eta=_probit_mean,
    )


@lru_cache(maxsize=None)
def binomial_cloglog() -> GLMFamily:
    """Binomial with the COMPLEMENTARY LOG-LOG link (glmnet 4.x's
    ``binomial(link = "cloglog")``): p = 1 - exp(-e^eta),
    loss(eta; y) = -[y log p + (1-y) log(1-p)] with log(1-p) = -e^eta.

    With t = e^eta and s = t e^{-t} / (1 - e^{-t}) (-> 1 as t -> 0),
    dloss/deta = (1-y) t - y s; the y=0 curvature is t itself —
    UNBOUNDED, so the family runs the adaptive per-lambda majorizer
    like poisson."""
    def _s(t):
        # t e^{-t} / (1 - e^{-t}), series-guarded at t -> 0.
        p = -jnp.expm1(-t)
        return jnp.where(t < 1e-6, 1.0 - 0.5 * t,
                         t * jnp.exp(-t) / jnp.maximum(p, 1e-30))

    def grad_eta(eta, y):
        t = jnp.exp(jnp.minimum(eta, 30.0))
        return (1.0 - y) * t - y * _s(t)

    def weight_eta(eta, y):
        t = jnp.exp(jnp.minimum(eta, 30.0))
        p = jnp.maximum(-jnp.expm1(-t), 1e-30)
        # d(-s)/deta = t e^{-t} (t - p) / p^2  (-> t/2 as t -> 0).
        w1 = jnp.where(t < 1e-6, 0.5 * t,
                       t * jnp.exp(-t) * (t - p) / (p * p))
        return y * w1 + (1.0 - y) * t

    def null_resid(y, intercept, w=None):
        pbar = _wmean(y, w) if intercept else jnp.asarray(
            -jnp.expm1(-1.0), y.dtype)
        pbar = jnp.clip(pbar, 1e-6, 1.0 - 1e-6)
        eta0 = jnp.log(-jnp.log1p(-pbar)) if intercept else 0.0
        return -grad_eta(jnp.full_like(y, eta0), y)

    def cv_loss(eta, y):
        t = np.exp(np.minimum(eta, 30.0))
        logp = np.log(np.maximum(-np.expm1(-t), 1e-300))
        return -2.0 * (y[None, :] * logp - (1.0 - y[None, :]) * t)

    return GLMFamily(
        name="binomial_cloglog",
        grad_eta=grad_eta,
        weight_eta=weight_eta,
        null_resid=null_resid,
        cv_loss=cv_loss,
        mean_eta=lambda eta: -np.expm1(-np.exp(np.minimum(eta, 30.0))),
    )


@lru_cache(maxsize=None)
def gamma_log() -> GLMFamily:
    """Gamma regression with the log link (glmnet 4.x's
    ``family = Gamma(link = "log")``), y > 0: the unit-shape negative
    log-likelihood loss(eta; y) = y e^{-eta} + eta (the shape parameter
    scales the objective uniformly, so the path is shape-free, exactly
    as glmnet's IRLS is).  Curvature y e^{-eta} is unbounded -> the
    adaptive per-lambda majorizer (the poisson protocol)."""
    def cv_loss(eta, y):
        # Gamma deviance: 2 [ (y - mu)/mu - log(y/mu) ], mu = e^eta.
        mu = np.exp(np.clip(eta, -30.0, 30.0))
        r = y[None, :] / mu
        return 2.0 * (r - 1.0 - np.log(np.maximum(r, 1e-300)))

    return GLMFamily(
        name="gamma_log",
        grad_eta=lambda eta, y: 1.0 - y * jnp.exp(
            jnp.minimum(-eta, 30.0)),
        weight_eta=lambda eta, y: y * jnp.exp(jnp.minimum(-eta, 30.0)),
        null_resid=lambda y, intercept, w=None: (
            y / _wmean(y, w) - 1.0 if intercept else y - 1.0),
        cv_loss=cv_loss,
        mean_eta=lambda eta: np.exp(np.clip(eta, -30.0, 30.0)),
    )


@lru_cache(maxsize=None)
def negative_binomial(theta: float = 1.0) -> GLMFamily:
    """Negative-binomial (NB2) regression with the log link and FIXED
    dispersion ``theta`` (the MASS::glm.nb likelihood at known theta —
    the overdispersed-count companion glmnet users reach through the
    4.x family-object path): loss(eta; y) = (y + theta) log(theta +
    e^eta) - y eta.  theta -> inf recovers poisson.  Curvature
    theta (y+theta) mu / (mu+theta)^2 <= (y+theta)/4 is data-dependent
    -> the adaptive per-lambda majorizer."""
    th = float(theta)
    if th <= 0:
        raise ValueError("theta must be positive")

    def grad_eta(eta, y):
        mu = jnp.exp(jnp.minimum(eta, 30.0))
        return (y + th) * mu / (mu + th) - y

    def weight_eta(eta, y):
        mu = jnp.exp(jnp.minimum(eta, 30.0))
        return th * (y + th) * mu / jnp.square(mu + th)

    def cv_loss(eta, y):
        # NB2 deviance at fixed theta: 2 [ y log(y/mu)
        #   - (y+theta) log((y+theta)/(mu+theta)) ], xlogy at y = 0.
        mu = np.exp(np.clip(eta, -30.0, 30.0))
        yb = y[None, :]
        ylogy = np.where(yb > 0,
                         yb * np.log(np.maximum(yb, 1e-300) / mu), 0.0)
        return 2.0 * (ylogy - (yb + th) * np.log((yb + th) / (mu + th)))

    def null_resid(y, intercept, w=None):
        mu0 = _wmean(y, w) if intercept else 1.0
        return y - (y + th) * mu0 / (mu0 + th)

    return GLMFamily(
        name="negative_binomial",
        grad_eta=grad_eta,
        weight_eta=weight_eta,
        null_resid=null_resid,
        cv_loss=cv_loss,
        param=th,
        mean_eta=lambda eta: np.exp(np.clip(eta, -30.0, 30.0)),
    )


def prep_design(X, standardize_x: bool, intercept: bool, weights=None):
    """Shared GLM design prep (also used by the consensus GLM,
    admm_tpu/parallel/consensus.py): returns ``(Xa, pen_mask, mean_x,
    sd_x)`` with the ones column prepended when an intercept is fitted.

    Flag semantics mirror the gaussian path's DataStd modes
    (data/standardize.py): standardize WITHOUT intercept scales but does
    NOT center (centering would covertly fit the intercept the caller
    disabled); the near-constant-column guard is the shared relative
    ``_guard``, not a bare sd > 0 check.  ``weights`` (normalized
    observation weights) make the moments WEIGHTED — the rows are NOT
    sqrt(w)-scaled (the smooth loss is not quadratic; the weights enter
    the grad/Hessian terms instead, see :func:`_glm_ops`).
    """
    from ..data.standardize import _guard

    n, p = X.shape
    dtype = X.dtype
    mean_x = jnp.zeros((p,), dtype)
    sd_x = jnp.ones((p,), dtype)
    if standardize_x:
        w = (jnp.ones((n,), dtype) if weights is None
             else jnp.asarray(weights, dtype))
        sw = jnp.sum(w)
        col_mean = jnp.sum(w[:, None] * X, axis=0) / sw
        c = X - col_mean[None, :]
        col_sd = jnp.sqrt(jnp.sum(w[:, None] * c * c, axis=0) / sw)
        sd_x = _guard(col_sd, col_mean)
        if intercept:
            mean_x = col_mean
            X = (X - mean_x[None, :]) / sd_x[None, :]
        else:
            X = X / sd_x[None, :]
    if intercept:
        Xa = jnp.concatenate([jnp.ones((n, 1), dtype), X], axis=1)
        pen_mask = jnp.concatenate([jnp.zeros((1,), dtype),
                                    jnp.ones((p,), dtype)])
    else:
        Xa = X
        pen_mask = jnp.ones((p,), dtype)
    return Xa, pen_mask, mean_x, sd_x


def recover_glm(coefs_a, mean_x, sd_x, intercept: bool):
    """Map (nlambda, q) standardized-scale GLM coefficients back to the
    original scale; returns ``(beta0, coef)``."""
    dtype = coefs_a.dtype
    if intercept:
        b0_std, slopes_std = coefs_a[:, 0], coefs_a[:, 1:]
    else:
        b0_std = jnp.zeros((coefs_a.shape[0],), dtype)
        slopes_std = coefs_a
    coef = slopes_std / sd_x[None, :]
    beta0 = b0_std - dot(slopes_std, mean_x / sd_x)
    return beta0, coef


def _glm_ops(Xa, ys, family: GLMFamily, n, q, pen_mask, alpha,
             newton_steps, obs_w=None, fixed_minv=None, offset=None,
             adaptive=False, bounds=None):
    """ProblemOps for the smooth-loss ADMM; ``Xa`` (n, q) includes the
    ones column when an intercept is fitted.  ``obs_w`` (normalized
    observation weights summing to n, or None) multiplies the
    per-observation gradient and IRLS-weight terms — the weighted loss
    ``1/n sum_i w_i loss(eta_i; y_i)`` with one extra (n,) multiply.

    ``fixed_minv``: precomputed ``(bound*X'WX/n + rho I)^{-1}`` for
    bounded-curvature families — the FIXED-MAJORIZER inner step
    ``b -= Minv grad`` (a majorize-minimize step: the majorizer
    dominates the true Hessian everywhere, so each step decreases the
    prox subproblem).  Replaces the per-step (n, q, q) Hessian build +
    Cholesky with two thin matvecs, and makes the batched (per-lambda
    lane) path share ONE (q, q) matrix instead of building per-lane
    Hessians.

    ``adaptive``: ``st.aux = (Minv, w_warm)`` rides the state instead —
    the majorizer inverse refreshed once per lambda at the warm start
    (the cox protocol, models/cox.py) — for UNBOUNDED-curvature
    families (poisson) where no global factorization exists.  Unlike
    cox's softmax weights, poisson's ``w = e^eta`` can GROW without
    bound mid-segment, so the stale inverse alone is not a majorizer;
    each inner step is damped by the pointwise curvature ratio
    ``r = max_i w_i(eta)/w_warm_i`` — ``(1/r) Minv grad`` is an exact
    MM step for the inflated majorizer ``r (H_warm + rho I) >=
    H(eta) + rho I``, so the inner iteration is monotone for ANY
    iterate.  Cost: one (n,) divide + max per step instead of the
    (n, q, q) Hessian build + Cholesky."""
    import jax.scipy.linalg as jsl

    def newton(v, rho, b0, minv, w_warm):
        def step(_, b):
            eta = dot(Xa, b)
            if offset is not None:
                eta = eta + offset
            g = family.grad_eta(eta, ys)
            if obs_w is not None:
                g = obs_w * g
            grad = dot(Xa.T, g) / n + rho * (b - v)
            if minv is not None:
                d = dot(minv, grad)
                if w_warm is None:
                    return b - d
                wc = family.weight_eta(eta, ys)
                r = jnp.maximum(jnp.max(wc / jnp.maximum(w_warm, 1e-12)),
                                1.0)
                return b - d / r
            w = family.weight_eta(eta, ys)
            if obs_w is not None:
                w = obs_w * w
            H = dot(Xa.T * w[None, :], Xa) / n
            H = H + rho * jnp.eye(q, dtype=Xa.dtype)
            c, low = jsl.cho_factor(H)
            return b - jsl.cho_solve((c, low), grad)

        return jax.lax.fori_loop(0, newton_steps, step, b0)

    def next_x(st):
        # Plain-ADMM engine: prox center from (z, y), not adj_*.
        v = st.z - st.y / st.rho
        if adaptive:
            minv, w_warm = st.aux
        else:
            minv, w_warm = fixed_minv, None
        return newton(v, st.rho, st.x, minv, w_warm)

    def next_z(st, x_new):
        v = x_new + st.y / st.rho
        pen = st.lam / st.rho * pen_mask
        zl1 = soft_threshold(v, alpha * pen)
        z = zl1 / (1.0 + pen * (1.0 - alpha))
        if bounds is not None:
            # glmnet's coefficient box: penalty and box are both
            # separable, so clip-after-shrink is the exact prox (the
            # gaussian path's argument, models/lasso.py::_tall_ops).
            z = jnp.clip(z, bounds[0], bounds[1])
        return z, st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.x),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=q, dim_dual=q,
    )


def _null_resid_with_offset(family, y, offset, intercept, w=None):
    """Null-model residual (-grad) when an OFFSET rides the linear
    predictor: the null intercept solves the monotone 1-D score
    ``sum w grad_eta(b0 + offset, y) = 0`` (loss convex in eta, so
    bisection on a widening bracket is globally convergent for every
    family); without an intercept the null predictor is the offset
    itself."""
    if not intercept:
        g = family.grad_eta(offset, y)
        return -(g if w is None else w * g)

    def score(b0):
        g = family.grad_eta(b0 + offset, y)
        return jnp.sum(g if w is None else w * g)

    # Bracket: the data range shifted past the offset range covers the
    # root for all shipped families (monotone nondecreasing score).
    lo = jnp.min(y) - jnp.max(jnp.abs(offset)) - 30.0
    hi = jnp.max(y) + jnp.max(jnp.abs(offset)) + 30.0

    def step(_, ab):
        l, h = ab
        mid = 0.5 * (l + h)
        pos = score(mid) < 0  # score increasing: root above mid
        return (jnp.where(pos, mid, l), jnp.where(pos, h, mid))

    l, h = jax.lax.fori_loop(0, 60, step, (lo, hi))
    b0 = 0.5 * (l + h)
    g = family.grad_eta(b0 + offset, y)
    return -(g if w is None else w * g)


def _glm_auto_rho(family, rho0, dtype):
    """Auto-rho = the family's curvature bound (1.0 when unbounded):
    after standardization the loss Hessian is ~ bound * I, so rho =
    bound balances it against the prox term.  Iteration-count sweep
    (DESIGN.md "GLM rho, measured"): binomial's optimum is
    rho ~ 0.2-0.3 (= its 1/4 bound, 2.7x fewer iterations than the
    old rho = 1 guess), huber's and poisson's are 1.0."""
    auto = family.curvature_bound or 1.0
    return jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                     jnp.asarray(auto, dtype))


def _glm_fixed_minv(Xa, family, rho, obs_w=None):
    """The fixed-majorizer inverse ``(bound * Xa'W Xa/n + rho I)^{-1}``
    (the fixed-majorizer x-update of _glm_ops)."""
    from ..linalg import ridge_inverse

    n = Xa.shape[0]
    Xw = Xa if obs_w is None else Xa * jnp.sqrt(obs_w)[:, None]
    H_fix = (family.curvature_bound / n) * dot(Xw.T, Xw)
    return ridge_inverse(H_fix, rho)


def _glm_engine(Xa, ys, family, lam_first, rho0, pen_mask, alpha,
                newton_steps, obs_w=None, hessian="exact", offset=None,
                bounds=None):
    """Returns (st0, solve, report, refresh): ``refresh`` is None
    except under ``hessian='adaptive'``, where it maps the warm-start
    iterate to the refreshed per-lambda majorizer inverse (rides
    st.aux; the cox protocol of models/cox.py applied to
    unbounded-curvature GLMs — e.g. poisson's H = Xa'diag(e^eta)Xa/n
    factorized ONCE per lambda instead of per inner step)."""
    from ..linalg import ridge_inverse

    n, q = Xa.shape
    dtype = Xa.dtype
    rho = _glm_auto_rho(family, rho0, dtype)
    fixed_minv = None
    if hessian == "fixed":
        assert family.curvature_bound is not None
        fixed_minv = _glm_fixed_minv(Xa, family, rho, obs_w)
    ops = _glm_ops(Xa, ys, family, n, q, pen_mask, alpha, newton_steps,
                   obs_w, fixed_minv, offset,
                   adaptive=(hessian == "adaptive"), bounds=bounds)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = jnp.zeros((q,), dtype)
    refresh = None
    aux = 0.0
    if hessian == "adaptive":
        def refresh(b):
            eta = dot(Xa, b)
            if offset is not None:
                eta = eta + offset
            w_warm = family.weight_eta(eta, ys)
            wm = w_warm if obs_w is None else obs_w * w_warm
            H = dot(Xa.T * wm[None, :], Xa) / n
            # (Minv, w_warm): the damping ratio compares RAW family
            # curvatures (obs_w scales both sides identically and a
            # zero weight must not poison the max).
            return (ridge_inverse(H, rho), w_warm)

        aux = refresh(zeros)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, aux=aux,
                     dtype=dtype)
    return st0, solve, (lambda st: st.z), refresh


@partial(jax.jit, static_argnames=("family", "standardize_x", "intercept",
                                   "nlambda", "path_mode", "trace_len",
                                   "newton_steps", "hessian"))
def _glm_path(X, y, nlambda, lambda_min_ratio, user_lams, rho, maxit,
              eps_abs, eps_rel, alpha, weights=None, offset=None,
              pf=None, limits=None, *,
              family, standardize_x, intercept, path_mode,
              trace_len=None, newton_steps=_NEWTON_STEPS,
              hessian="auto"):
    n, p = X.shape
    dtype = X.dtype
    fam = family() if not isinstance(family, GLMFamily) else family
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))  # glmnet: weights sum to n
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    q = Xa.shape[1]
    if pf is not None:
        # Per-coordinate penalty factors ride the existing mask (the
        # intercept entry is already 0).
        pfq = (jnp.concatenate([jnp.ones((1,), dtype), pf])
               if intercept else pf)
        pen_mask = pen_mask * pfq
    bounds = None
    if limits is not None:
        # Original-scale box -> standardized scale: coef_orig =
        # slopes_std / sd_x (recover_glm), so the box maps by sd_x;
        # the intercept coordinate stays unconstrained (glmnet).
        lo, up = limits[0] * sd_x, limits[1] * sd_x
        if intercept:
            ninf = jnp.full((1,), -jnp.inf, dtype)
            lo = jnp.concatenate([ninf, lo])
            up = jnp.concatenate([-ninf, up])
        bounds = (lo, up)

    if user_lams is None:
        # glmnet lambda_max rule: the (weighted) null model's score
        # against X.  With an offset the null intercept solves the
        # offset-shifted score (generic bisection; glmnet's offset
        # semantics).
        if offset is not None:
            r0 = _null_resid_with_offset(fam, y, offset, intercept, w)
        else:
            r0 = fam.null_resid(y, intercept, w)
            if w is not None:
                r0 = w * r0
        scores = jnp.abs(dot(Xs.T, r0)) / n
        if pf is not None:
            # Factor-aware KKT boundary over PENALIZED coordinates
            # (glmnet's rule; zero-factor coordinates never gate the
            # grid top — they are always in the model).
            scores = jnp.where(pf > 0,
                               scores / jnp.maximum(pf, 1e-12), 0.0)
        lam0 = jnp.max(scores) / jnp.maximum(alpha, 1e-3)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams

    if hessian == "auto":
        # Bounded curvature -> the one-time-factorized fixed majorizer;
        # unbounded (poisson) -> the per-lambda adaptive majorizer with
        # the curvature-ratio damping safeguard (_glm_ops), which skips
        # exact's per-step Cholesky.  Chosen before the GPU port; not yet
        # measured on the H100 (ROADMAP A5).
        hessian = ("fixed" if fam.curvature_bound is not None
                   else "adaptive")
    if hessian == "fixed" and fam.curvature_bound is None:
        raise ValueError(
            f"family {fam.name!r} has unbounded curvature; "
            "hessian='fixed' is not available")
    if hessian == "adaptive":
        # The per-lambda refresh anchors on the warm-start iterate —
        # batch lanes hold different iterates, so adaptive is
        # scan-only (same restriction as cox's shipped protocol).
        path_mode = "scan"
    if path_mode == "auto":
        # With the fixed majorizer the batched lanes share one (q, q)
        # matrix; with exact per-lane Hessians the scan does less work.
        # Tuned before the GPU port (DESIGN.md "GLM tier, closed"); not
        # yet measured on the H100 (ROADMAP A5).
        path_mode = "batch" if hessian == "fixed" else "scan"

    st0, solve, report, refresh = _glm_engine(
        Xa, y, fam, lams[0], rho, pen_mask, alpha, newton_steps,
        obs_w=w, hessian=hessian, offset=offset, bounds=bounds)
    if path_mode == "batch":
        bsolve = make_batched_solver(solve)
        st = _batched_cold_states(lams.shape[0], q, st0.rho, lams, dtype)
        st = bsolve(st, maxit, eps_abs, eps_rel)
        coefs_a, niter, traces = st.z, st.it, None
    else:
        _, coefs_a, niter, traces = _scan_path(st0, solve, report, lams,
                                               maxit, eps_abs, eps_rel,
                                               trace_len, refresh=refresh)

    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def glm_lasso_path(X, y, family, *,
                   lambdas: Optional[jnp.ndarray] = None,
                   nlambda: int = 50, lambda_min_ratio: float = 1e-2,
                   alpha: float = 1.0, standardize: bool = True,
                   intercept: bool = True, maxit: int = 10000,
                   eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                   rho: float = -1.0, path_mode: str = "auto",
                   trace_len: Optional[int] = None,
                   newton_steps: int = _NEWTON_STEPS,
                   weights: Optional[jnp.ndarray] = None,
                   offset: Optional[jnp.ndarray] = None,
                   penalty_factor: Optional[jnp.ndarray] = None,
                   lower_limits=None, upper_limits=None, exclude=None,
                   hessian: str = "auto", data_mesh=None,
                   dfmax: Optional[int] = None,
                   pmax: Optional[int] = None,
                   dtype=jnp.float32) -> PathResult:
    """Solve a penalized smooth-loss path for any :class:`GLMFamily`.

    ``family`` is a GLMFamily instance (:func:`binomial`,
    :func:`huber`, :func:`poisson`) or a zero-argument factory.
    ``weights`` (extension — glmnet's ``weights`` argument for every
    family): observation weights, normalized to sum to n; the loss,
    the standardization moments and the lambda grid all become weighted
    (an integer weight of k is exactly equivalent to repeating the row
    k times — tested per family).  ``offset`` (glmnet's ``offset``
    argument): a fixed (n,) term added to the linear predictor —
    ``eta = b0 + X b + offset`` — for exposure/rate models (e.g.
    poisson with ``offset = log(exposure)``); the auto grid's null
    intercept solves the offset-shifted score.
    ``penalty_factor`` / ``lower_limits`` / ``upper_limits`` /
    ``exclude`` (glmnet's per-coefficient arguments, same semantics as
    :func:`admm_tpu.lasso_path`): factors rescale each coordinate's
    penalty (threshold ``lambda * pf_j``, factor-aware grid top,
    column-rescaling equivalence tested per family); limits clip the
    prox to an original-scale box containing 0 (nonnegative logistic
    via ``lower_limits=0``); ``exclude`` forces variables out (the
    lower=upper=0 box, pinned equal to deleting the columns).
    ``hessian``: "fixed" uses the
    one-time-factorized curvature majorizer in the x-update (available
    for bounded-curvature families: binomial, huber), "adaptive"
    refreshes a local majorizer once per lambda at the warm start with
    a pointwise curvature-ratio damping safeguard (unbounded families —
    poisson; the cox protocol of models/cox.py), "exact" rebuilds the
    (q, q) Newton Hessian every inner step, "auto" (default) picks
    "fixed" when the family has a curvature bound and "adaptive"
    otherwise — same solutions to solver tolerance, with less work per
    lambda (DESIGN.md "GLM tier"; the speed-up is not yet measured on
    the H100, ROADMAP A5).
    ``data_mesh`` (operator parallelism): X/y are ROW-sharded over the
    mesh so the per-step gradient/Hessian reductions (and the
    fixed-majorizer Gram build) distribute via the SPMD partitioner,
    with the (q,) iterate replicated — the same pattern as
    ``lasso_path(data_mesh=...)``.  Other options as in
    :func:`admm_tpu.models.logistic.logistic_lasso_path`.
    """
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype).ravel()
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        y = put_dim_sharded(y, data_mesh, 0)
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1] for GLM paths")
    if hessian not in ("auto", "fixed", "exact", "adaptive"):
        raise ValueError(
            "hessian must be 'auto', 'fixed', 'exact' or 'adaptive'")
    if path_mode not in ("auto", "scan", "batch"):
        raise ValueError("path_mode must be 'auto', 'scan' or 'batch'")
    lams = (None if lambdas is None
            else jnp.sort(jnp.asarray(lambdas, dtype))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    off = (None if offset is None
           else jnp.asarray(offset, dtype).ravel())
    if off is not None and off.shape != (X.shape[0],):
        raise ValueError("offset must have one entry per row")
    from .lasso import validate_pf_limits

    pf, limits = validate_pf_limits(penalty_factor, exclude,
                                    lower_limits, upper_limits,
                                    X.shape[1], dtype)
    res = _glm_path(X, y, int(nlambda), lambda_min_ratio, lams, rho,
                    maxit, eps_abs, eps_rel, alpha, w, off, pf, limits,
                    family=family,
                    standardize_x=standardize, intercept=intercept,
                    path_mode=path_mode, trace_len=trace_len,
                    newton_steps=int(newton_steps), hessian=hessian)
    if dfmax is not None or pmax is not None:
        from .lasso import _truncate_path
        res = _truncate_path(res, dfmax, pmax)
    return res


def huber_lasso_path(X, y, *, M: float = 1.345, **kw) -> PathResult:
    """Robust (Huber-loss) Lasso/Enet path — the smooth bridge between
    the reference's gaussian Lasso and its LAD."""
    return glm_lasso_path(X, y, huber(float(M)), **kw)


def poisson_lasso_path(X, y, **kw) -> PathResult:
    """Sparse log-linear Poisson regression path (y = counts >= 0).

    ``newton_steps`` defaults to 1 here (vs the generic 2): poisson
    runs the exact-Hessian engine on the warm-started scan, where one
    exact Newton step per x-update reproduces the 2-step iterates to 8
    decimals with identical outer iteration counts (measured; each
    saved step is an (n, q, q) Hessian build + Cholesky — the dominant
    cost of the family's path)."""
    kw.setdefault("newton_steps", 1)
    return glm_lasso_path(X, y, poisson(), **kw)
