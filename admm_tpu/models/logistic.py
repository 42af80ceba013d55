"""Sparse logistic regression (binomial Lasso / Elastic Net) by ADMM.

Extension beyond the reference (which is gaussian-only): the glmnet
binomial objective ::

    minimize  1/n sum_i [log(1 + exp(x_i'b + b0)) - y_i (x_i'b + b0)]
              + lambda (alpha ||b||_1 + (1-alpha)/2 ||b||_2^2)

with y in {0, 1} and the intercept unpenalized.  This is the
``binomial()`` instance of the generic smooth-loss GLM engine — ADMM
with an inexact 2-step damped-Newton x-update; see
admm_tpu/models/glm.py for the machinery and the other families
(huber, poisson).  The distributed variant is
``admm_tpu.parallel.consensus.parallel_logistic_lasso_path``.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .glm import _NEWTON_STEPS, binomial, glm_lasso_path
from .lasso import PathResult


def logistic_lasso_path(X, y, *, lambdas: Optional[jnp.ndarray] = None,
                        nlambda: int = 50,
                        lambda_min_ratio: float = 1e-2,
                        alpha: float = 1.0,
                        standardize: bool = True, intercept: bool = True,
                        maxit: int = 10000, eps_abs: float = 1e-5,
                        eps_rel: float = 1e-5, rho: float = -1.0,
                        path_mode: str = "auto",
                        trace_len: Optional[int] = None,
                        newton_steps: int = _NEWTON_STEPS,
                        weights: Optional[jnp.ndarray] = None,
                        offset: Optional[jnp.ndarray] = None,
                        penalty_factor: Optional[jnp.ndarray] = None,
                        lower_limits=None, upper_limits=None,
                        exclude=None,
                        hessian: str = "auto", data_mesh=None,
                        dfmax: Optional[int] = None,
                        pmax: Optional[int] = None,
                        dtype=jnp.float32) -> PathResult:
    """Solve the L1/elastic-net logistic regression lambda path.

    ``y`` must be 0/1 labels.  ``alpha`` mixes L1 and ridge as in the
    gaussian Elastic Net.  ``path_mode="auto"`` (default) resolves to
    "batch" under the default fixed-majorizer x-update (all lambda
    lanes share ONE factorized (q, q) matrix — DESIGN.md "GLM tier,
    closed"; tuned before the GPU port, not yet measured on the H100);
    "scan" is the
    warm-started sequential path; hessian="exact" restores the
    per-step Newton Hessian build.  ``trace_len`` as in the Lasso path
    (implies scan).  Oracle-pinned against sklearn saga
    (tests/test_logistic.py).
    """
    return glm_lasso_path(X, y, binomial(), lambdas=lambdas,
                          nlambda=nlambda,
                          lambda_min_ratio=lambda_min_ratio, alpha=alpha,
                          standardize=standardize, intercept=intercept,
                          maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel,
                          rho=rho, path_mode=path_mode,
                          trace_len=trace_len, newton_steps=newton_steps,
                          weights=weights, offset=offset,
                          penalty_factor=penalty_factor,
                          lower_limits=lower_limits,
                          upper_limits=upper_limits, exclude=exclude,
                          hessian=hessian, dfmax=dfmax, pmax=pmax,
                          data_mesh=data_mesh, dtype=dtype)
