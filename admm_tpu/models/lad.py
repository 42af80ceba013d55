"""LAD (least absolute deviations / median regression) solver.

Model: ``minimize ||y - X beta||_1`` with n > p, optionally with an
intercept; data is always standardized (reference: src/LAD.cpp:34-35,
R/20_admm_lad.R:21-31).

ADMM formulation in range space (reference: src/ADMMLAD.h:7-29): with
``xx := X beta`` constrained to Range(X),

    minimize f(xx) + g(z)   s.t.  xx - z = y
    f = indicator{xx in Range(X)},  g = ||.||_1

so the x-update is the orthogonal projection onto Range(X):
``x = X (X'X)^{-1} X' v`` with ``v = y - adj_y/rho + adj_z``
(reference: src/ADMMLAD.h:62-78), and the z-update is a soft-threshold
with penalty ``1/rho`` (reference: src/ADMMLAD.h:94-98).

Accelerator choices:

* The reference builds a dense n x n hat matrix when n <= 2000 so it can
  use one BLAS ``dsymv`` per iteration (reference: src/ADMMLAD.h:182-203).
  Here every size uses the factored projection ``X ((X'X)^{-1} (X' v))``
  — two skinny matvecs + one p x p matvec, with a one-time explicit
  inverse instead of a cached Cholesky (no per-iteration triangular
  solves).
* The accelerated FADMM engine runs with rho FIXED at the user value
  (default 1.0, reference: R/20_admm_lad.R:28-31).  The reference
  inherits FADMMBase::update_rho unoverridden, but combining Nesterov
  acceleration with the adaptive ladder violates the restart analysis's
  constant-penalty assumption and can cycle without converging (observed
  on small problems — see admm_tpu/models/bp.py).

The final coefficients are recovered by one least-squares solve
``beta = (X'X)^{-1} X' (y - adj_y/rho + adj_z)``
(reference: src/ADMMLAD.h:220-225) and un-standardized.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.engine import (ProblemOps, make_fadmm_solver, make_state,
                           make_traced_solve)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..data.standardize import recover, standardize
from ..linalg import chol_inverse, dot, gram


class LADResult(NamedTuple):
    beta0: jnp.ndarray  # scalar intercept (0 when intercept=False)
    coef: jnp.ndarray   # (p,) coefficients on the original scale
    niter: jnp.ndarray  # int32
    # (trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho)
    # when tracing was requested (admm_tpu.diag.trace).
    trace: Optional[jnp.ndarray] = None


def _asym_soft_threshold(v, t_pos, t_neg):
    """Prox of the asymmetric l1 ``w -> t_pos max(w, 0) + t_neg
    max(-w, 0)`` at unit rho: shifted shrinkage with a one-sided
    threshold per sign (the quantile-loss prox; reduces to the ordinary
    soft-threshold when t_pos == t_neg)."""
    return jnp.where(v > t_pos, v - t_pos,
                     jnp.where(v < -t_neg, v + t_neg, 0.0))


def _lad_ops(Xs, ys, Ginv, ynorm, n, p, tau=0.5) -> ProblemOps:
    """``tau`` generalizes the z-prox to the QUANTILE check loss
    (extension): the solver state z is (fitted - y) = -residual, so the
    loss ``2 rho_tau(r) = 2 tau max(r,0) + 2(1-tau) max(-r,0)`` puts
    weight 2(1-tau) on z > 0 and 2 tau on z < 0.  The factor 2 makes
    tau = 0.5 EXACTLY the reference's LAD (threshold 1/rho both sides,
    reference: src/ADMMLAD.h:94-98) — same iterates, not just the same
    argmin."""
    def project(v):
        """Orthogonal projection onto Range(X): X (X'X)^-1 X' v."""
        return dot(Xs, dot(Ginv, dot(Xs.T, v)))

    def next_x(st):
        v = ys - st.adj_y / st.rho + st.adj_z
        return project(v)

    def next_z(st, x_new):
        v = x_new - ys + st.adj_y / st.rho
        return _asym_soft_threshold(v, 2.0 * (1.0 - tau) / st.rho,
                                    2.0 * tau / st.rho), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - ys - z,
        eps_primal_scale=lambda st: jnp.maximum(
            jnp.maximum(l2norm(st.x), l2norm(st.z)), ynorm),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=n, dim_dual=n,
    )


@partial(jax.jit, static_argnames=("intercept", "trace_len", "tau"))
def _lad_fit(X, y, rho, maxit, eps_abs, eps_rel, *, intercept,
             trace_len=None, tau=0.5):
    """Deliberate fix over the reference for ``intercept=True``: the
    reference mean-centers X and y and reconstructs ``beta0 = mean(y) -
    sum(coef * mean(x))`` (reference: src/LAD.cpp:34, src/DataStd.h:157),
    which FORCES the mean-based intercept — but the L1-optimal intercept
    is median-like, and under heavy-tailed noise (the regime LAD exists
    for) the forced mean intercept is arbitrarily suboptimal (measured:
    10% higher L1 objective than the LP optimum under Cauchy noise).
    Here the intercept is an unpenalized ones column INSIDE the
    range-space projection, so it is optimized under the L1 loss itself;
    X is still centered+scaled for conditioning, which the free column
    absorbs exactly.
    """
    n, p = X.shape
    dtype = X.dtype
    # LAD always standardizes X (reference: src/LAD.cpp:34).
    Xs, ys, stats = standardize(X, y, standardize_x=True,
                                intercept=intercept)
    if intercept:
        Xa = jnp.concatenate([jnp.ones((n, 1), dtype), Xs], axis=1)
    else:
        Xa = Xs
    XtX = gram(Xa)
    # X'X is unregularised here; jitter guards f32 conditioning (the
    # reference relies on float64, SURVEY.md section 2.6 caveat 2).
    jitter = 1e-6 if dtype == jnp.float32 else 0.0
    Ginv = chol_inverse(XtX, jitter=jitter)
    ynorm = l2norm(ys)

    ops = _lad_ops(Xa, ys, Ginv, ynorm, n, Xa.shape[1], tau=tau)
    # Fixed rho, as for BP: FADMM acceleration + the adaptive ladder
    # can cycle (see admm_tpu/models/bp.py); the projection is
    # rho-free so a fixed rho = 1.0 (the reference default,
    # R/20_admm_lad.R:28-31) converges reliably.
    solve = make_fadmm_solver(ops, adapt_rho=False)

    zeros = jnp.zeros((n,), dtype)
    st0 = make_state(zeros, zeros, zeros, rho, 0.0, dtype=dtype)
    buf = None
    if trace_len is None:
        st = solve(st0, maxit, eps_abs, eps_rel)
    else:
        st, buf = make_traced_solve(solve, trace_len)(
            st0, maxit, eps_abs, eps_rel)

    # beta = (X'X)^-1 X' (y - adj_y/rho + adj_z)
    # (reference: src/ADMMLAD.h:220-225)
    v = ys - st.adj_y / st.rho + st.adj_z
    coef_std = dot(Ginv, dot(Xa.T, v))
    if intercept:
        a, slopes = coef_std[0], coef_std[1:]
        # ys = (y - mean_y)/scale_y, Xs = (X - mean_x)/scale_x:
        # y ~ mean_y + scale_y*a + sum_j coef_j (X_j - mean_x_j).
        coef = slopes / stats.scale_x * stats.scale_y
        beta0 = (stats.mean_y + stats.scale_y * a
                 - jnp.sum(coef * stats.mean_x))
    else:
        beta0, coef = recover(stats, coef_std, standardize_x=True,
                              intercept=False)
    return LADResult(beta0=beta0, coef=coef, niter=st.it, trace=buf)


def lad_fit(X, y, *, intercept: bool = True, maxit: int = 10000,
            eps_abs: Optional[float] = None,
            eps_rel: Optional[float] = None,
            rho: Optional[float] = None,
            trace_len: Optional[int] = None,
            data_mesh=None, dtype=None) -> LADResult:
    """Fit median regression by FADMM.

    ``data_mesh`` (extension — operator parallelism, as in
    :func:`admm_tpu.models.lasso.lasso_path`): a ``jax.sharding.Mesh``
    over which X and y are ROW-sharded; the X'X build, the range-space
    projection's two skinny matvecs per iteration and the final
    least-squares recovery distribute via XLA's SPMD partitioner (the
    reference's implicit BLAS threading accelerates this model the same
    way, reference: src/LAD.cpp:16 + src/Makevars:3-4).

    Defaults mirror the reference R API (reference: R/20_admm_lad.R:28-31:
    eps 1e-4, rho = 1) — under f64.  The reference runs this model in
    DOUBLE precision (reference: src/LAD.cpp:16) and its 1e-4 tolerance
    is calibrated to f64 solution quality; in f32 the same nominal eps
    leaves ~30%% more coefficient error than the reference publishes,
    so the f32 default tightens to 2e-5, which restores it (accuracy
    sweep: DESIGN.md "f64-class accuracy"; its wall cost on the GPU is
    not yet measured, ROADMAP A5).  Pass
    eps_abs/eps_rel explicitly for literal reference semantics.
    Requires n > p (validated by the builder API).  ``trace_len``
    records the per-iteration residual trace.
    """
    if dtype is None:
        # Match the reference's float64 for this model class when the
        # backend supports it (reference: src/LAD.cpp / src/BP.cpp use
        # double); float32 otherwise (SURVEY.md 2.6 caveat 2).
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == jnp.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == jnp.float64 else 2e-5
    if rho is None:
        # The reference defaults rho = 1.0 (R/20_admm_lad.R:28-31), which
        # is mistuned for its own standardized problem: a measured sweep
        # across shapes (DESIGN.md "rho defaults, re-tuned") shows
        # rho = 5 converging 1.5-2.3x faster with an equal-or-better L1
        # objective.  Pass rho=1.0 for the reference's literal default.
        rho = 5.0
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        y = put_dim_sharded(y, data_mesh, 0)
    return _lad_fit(X, y, rho, maxit, eps_abs, eps_rel,
                    intercept=intercept,
                    trace_len=(None if trace_len is None
                               else int(trace_len)))


def quantile_fit(X, y, *, tau: float = 0.5, intercept: bool = True,
                 maxit: int = 10000, eps_abs: Optional[float] = None,
                 eps_rel: Optional[float] = None,
                 rho: Optional[float] = None,
                 trace_len: Optional[int] = None,
                 data_mesh=None, dtype=None) -> LADResult:
    """QUANTILE regression (extension): ``minimize sum_i rho_tau(y_i -
    x_i'b)`` with the check loss ``rho_tau(r) = r (tau - 1{r < 0})``,
    n > p.  ``tau = 0.5`` reduces EXACTLY to :func:`lad_fit` (median
    regression — same iterates, the check loss is then |r|/2 doubled
    back to |r|); other quantiles swap the z-prox for the asymmetric
    soft-threshold (see _lad_ops) — everything else (range-space
    projection, free quantile-optimal intercept, FADMM engine,
    defaults) is shared with LAD.  Oracle: sklearn
    QuantileRegressor(quantile=tau) (tests/test_lad_bp_dantzig.py).
    """
    if not 0.0 < tau < 1.0:
        raise ValueError("tau must be in (0, 1)")
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == jnp.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == jnp.float64 else 2e-5
    if rho is None:
        rho = 5.0  # LAD's measured default (same solver geometry)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    if X.shape[0] <= X.shape[1]:
        raise ValueError("nrow(x) must be greater than ncol(x)")
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        y = put_dim_sharded(y, data_mesh, 0)
    return _lad_fit(X, y, rho, maxit, eps_abs, eps_rel,
                    intercept=intercept,
                    trace_len=(None if trace_len is None
                               else int(trace_len)),
                    tau=float(tau))
