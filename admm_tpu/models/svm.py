"""Linear Support Vector Machine by ADMM.

Extension beyond the reference: the soft-margin linear SVM

    minimize_{w, b}  1/2 ||w||^2 + C * sum_i loss(1 - y_i (x_i' w + b))

with ``loss`` the hinge ``max(0, .)`` or squared hinge ``max(0, .)^2``
(sklearn ``LinearSVC``'s two losses) — another classic ADMM splitting
(Boyd et al. 2011 section 8.2 treats exactly this pairing of a strongly
convex quadratic with a separable piecewise loss).

Splitting over the MARGINS, the same range-space move as the LAD solver
(reference: src/ADMMLAD.h:20-29): let ``A = diag(y) [X, 1]`` and
``v = [w; b]``; constrain ``A v - z = 0`` with

    f(v) = 1/2 ||w||^2        (b unpenalized),
    g(z) = C * sum_i loss(1 - z_i).

* x-update: cached SPD solve ``(P + rho A'A) v = rho A'(z - y_d/rho)``
  with ``P = diag(1,..,1,0)`` — one-time explicit inverse, each
  iteration two thin matvecs (the tall-Lasso pattern,
  reference: src/ADMMLassoTall.h:70-80);
* z-update: the separable hinge prox in closed form
  (``v >= 1 -> v``; ``v <= 1 - C/rho -> v + C/rho``; else ``1``), or
  the squared-hinge prox ``(rho v + 2C) / (rho + 2C)`` below margin;
* accelerated FADMM engine with FIXED rho (the factorization is
  rho-dependent, exactly the reference's reason for pinning it).

The C axis is a BATCH axis: the cached inverse depends on rho only, so
every C in the regularization path shares ONE factorization and solves
as batched lanes in a single while_loop (``svm_path``).

Per-observation weights ``w_i`` scale the per-row penalty ``C w_i``
(class weighting, and the hook that makes fold-as-lane one-pass CV
exact).  Oracle: sklearn ``LinearSVC`` (liblinear) at matching
conventions — tests/test_svm.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (ProblemOps, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..core.prox import l2norm, sqnorm
from ..linalg import chol_inverse, dot, gram
from .lasso import _batched_cold_states, _scan_path


class SVMResult(NamedTuple):
    """Device-side SVM C-path result."""
    Cs: jnp.ndarray         # (k,) regularization values (descending)
    coef: jnp.ndarray       # (k, p) weight vectors
    intercept: jnp.ndarray  # (k,) biases (0 when intercept=False)
    niter: jnp.ndarray      # (k,) int32 ADMM iteration counts
    trace: Optional[jnp.ndarray] = None
    # The original class labels (negative, positive) — attached outside
    # the jitted driver; predict(type="class") maps back through them.
    classes: Optional[tuple] = None


def hinge_prox(v, scale):
    """prox of ``scale * max(0, 1 - z)`` at v (scale = C w_i / rho)."""
    return jnp.where(v >= 1.0, v,
                     jnp.where(v <= 1.0 - scale, v + scale,
                               jnp.ones_like(v)))


def sq_hinge_prox(v, scale):
    """prox of ``scale * max(0, 1 - z)^2`` at v (scale = C w_i / rho
    with the rho already divided out: solves
    ``min scale*(1-z)^2 + 1/2 (z-v)^2``)."""
    return jnp.where(v >= 1.0, v,
                     (v + 2.0 * scale) / (1.0 + 2.0 * scale))


def _svm_ops(A, Minv, loss, obs_w, n, d) -> ProblemOps:
    """A = diag(y) [X, (1)]; v = [w, (b)]; margins z = A v."""
    At = A.T

    def next_x(st):
        rhs = dot(At, st.rho * st.adj_z - st.adj_y)
        return dot(Minv, rhs)

    prox = hinge_prox if loss == "hinge" else sq_hinge_prox

    def next_z(st, x_new):
        Av = dot(A, x_new)
        v = Av + st.adj_y / st.rho
        return prox(v, st.lam * obs_w / st.rho), Av

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.aux),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(dot(At, st.y)),
        dual_residual=lambda st, z_new: st.rho * l2norm(
            dot(At, z_new - st.z)),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=d, dim_dual=n,
    )


def _svm_setup(X, ysign, intercept, rho0, dtype, Cs):
    n, p = X.shape
    cols = [X * ysign[:, None]]
    if intercept:
        cols.append(ysign[:, None])
    A = jnp.concatenate(cols, axis=1)
    d = A.shape[1]
    # Auto-rho: a 3-shape x 2-loss x 4-C sweep (DESIGN.md "SVM rho")
    # puts the iteration-count optimum close to 0.3 * C^(1/3) for both
    # losses — a sublinear power law of the penalty scale, like the
    # reference's lambda^(2/3) rule (reference: src/ADMMLassoTall.h:
    # 194-202).  Batch lanes share ONE factorization, so the path uses
    # the geometric-mean C.
    gm = jnp.exp(jnp.mean(jnp.log(Cs)))
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    0.3 * jnp.cbrt(gm))
    P = jnp.ones((d,), dtype)
    if intercept:
        P = P.at[-1].set(0.0)
    M = jnp.diag(P) + rho * gram(A)
    Minv = chol_inverse(M, jitter=1e-7 if dtype == jnp.float32 else 0.0)
    return A, Minv, rho, d


def _svm_engine(X, ysign, Cs, obs_w, loss, intercept, rho0):
    dtype = X.dtype
    n = X.shape[0]
    A, Minv, rho, d = _svm_setup(X, ysign, intercept, rho0, dtype, Cs)
    ops = _svm_ops(A, Minv, loss, obs_w, n, d)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    zn = jnp.zeros((n,), dtype)
    st0 = make_state(jnp.zeros((d,), dtype), zn, zn, rho, Cs[0],
                     aux=zn, dtype=dtype)
    return st0, solve, (lambda st: st.x)


@partial(jax.jit, static_argnames=("loss", "intercept", "path_mode",
                                   "trace_len"))
def _svm_path_dev(X, ysign, Cs, obs_w, rho0, maxit, eps_abs, eps_rel, *,
                  loss, intercept, path_mode, trace_len=None):
    n, p = X.shape
    dtype = X.dtype
    if path_mode == "batch":
        A, Minv, rho, d = _svm_setup(X, ysign, intercept, rho0, dtype, Cs)
        ops = _svm_ops(A, Minv, loss, obs_w, n, d)
        solve = make_batched_solver(make_fadmm_solver(ops,
                                                      adapt_rho=False))
        k = Cs.shape[0]
        st = _batched_cold_states(k, d, rho, Cs, dtype, aux_dim=n)
        zn = jnp.zeros((k, n), dtype)
        st = st._replace(z=zn, y=zn, adj_z=zn, adj_y=zn)
        st = solve(st, maxit, eps_abs, eps_rel)
        vs, niter, traces = st.x, st.it, None
    else:
        st0, solve, report = _svm_engine(X, ysign, Cs, obs_w, loss,
                                         intercept, rho0)
        _, vs, niter, traces = _scan_path(st0, solve, report, Cs, maxit,
                                          eps_abs, eps_rel, trace_len)
    if intercept:
        coefs, b = vs[:, :p], vs[:, p]
    else:
        coefs, b = vs, jnp.zeros((Cs.shape[0],), dtype)
    return SVMResult(Cs=Cs, coef=coefs, intercept=b, niter=niter,
                     trace=traces)


def _as_sign(y):
    y = np.asarray(y)
    classes = np.unique(y)
    if classes.size != 2:
        raise ValueError("SVM needs exactly two classes in y")
    if set(classes.tolist()) == {-1, 1}:
        return y.astype(np.float64), (-1, 1)
    return np.where(y == classes[1], 1.0, -1.0), tuple(classes.tolist())


def svm_path(X, y, *, Cs=None, nC: int = 20, C_min_ratio: float = 1e-3,
             loss: str = "squared_hinge", intercept: bool = True,
             weights=None, maxit: int = 20000, eps_abs: float = 1e-5,
             eps_rel: float = 1e-5, rho: float = -1.0,
             path_mode: str = "batch",
             trace_len: Optional[int] = None, data_mesh=None,
             dtype=jnp.float32) -> SVMResult:
    """Solve the linear-SVM C path on device.

    ``y`` holds two classes (any labels; mapped to ±1 with the larger
    label positive, sklearn's convention).  ``loss``:
    ``"squared_hinge"`` (sklearn LinearSVC's default) or ``"hinge"``.
    All ``Cs`` solve as batched lanes against ONE cached factorization
    (``path_mode="batch"``); ``"scan"`` warm-starts sequentially.
    ``weights`` scale each row's misclassification penalty ``C w_i``
    (class weights; fold-as-lane CV).  The auto grid is a fixed
    geometric ``[C_min_ratio, 1]`` sweep of ``nC`` points — C has no
    data-derived null threshold (every C > 0 fits a nontrivial SVM);
    pass explicit ``Cs`` to relocate it.
    """
    ysign, classes = _as_sign(y)
    X = jnp.asarray(X, dtype)
    if data_mesh is not None:
        # Operator parallelism: row-shard the data; the gram(A) build
        # becomes per-shard partials + all-reduce and the per-iteration
        # margin products partition over rows (lasso_path(data_mesh=)
        # pattern).
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
    n, p = X.shape
    if ysign.shape[0] != n:
        raise ValueError("x and y must have the same number of rows")
    if loss not in ("hinge", "squared_hinge"):
        raise ValueError("loss must be 'hinge' or 'squared_hinge'")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    obs_w = (jnp.ones((n,), dtype) if weights is None
             else jnp.asarray(weights, dtype).ravel())
    if Cs is None:
        Cs = np.geomspace(1.0, C_min_ratio, int(nC))
    Cs_np = np.atleast_1d(np.asarray(Cs, np.float64))
    if np.any(Cs_np <= 0) or not np.all(np.isfinite(Cs_np)):
        # C <= 0 silently NaNs the whole solve (auto-rho hits 0 and
        # the prox divides by it); refuse up front.
        raise ValueError("Cs must be positive and finite")
    Cs = jnp.sort(jnp.asarray(Cs_np, dtype))[::-1]
    res = _svm_path_dev(X, jnp.asarray(ysign, dtype), Cs, obs_w, rho,
                        maxit, eps_abs, eps_rel, loss=loss,
                        intercept=bool(intercept),
                        path_mode=path_mode, trace_len=trace_len)
    return res._replace(classes=classes)


def svm_fit(X, y, *, C: float = 1.0, **kw) -> SVMResult:
    """Single-C soft-margin linear SVM (see :func:`svm_path`)."""
    return svm_path(X, y, Cs=[C], **kw)


# ---------------------------------------------------------------------
# Cross-validation over the C grid (one-pass fold-as-lane protocol).
# ---------------------------------------------------------------------

class CVSVMResult(NamedTuple):
    Cs: np.ndarray        # (k,) shared grid
    cvm: np.ndarray       # (k,) mean held-out loss
    cvsd: np.ndarray      # (k,) its standard error
    C_min: float          # grid point minimising cvm
    C_1se: float          # smallest C with cvm <= min + 1 se
    fit: SVMResult        # full-data path on the same grid
    foldid: np.ndarray    # (n,) fold assignment


@partial(jax.jit, static_argnames=("loss", "intercept"))
def _cv_svm_core(X, ysign, masks, w, Cs, rho0, maxit, eps_abs, eps_rel,
                 *, loss, intercept):
    """All folds' C paths + held-out decision values in ONE program.

    Fold f's fit weights are ``w * mask_f`` (held-out rows get penalty
    0*C — they drop out of the hinge term exactly, so each lane IS the
    training-subset fit); the returned (n, k) decision values select
    each row's own held-out fold on device."""

    def fold_fit(mask):
        res = _svm_path_dev(X, ysign, Cs, w * mask, rho0, maxit,
                            eps_abs, eps_rel, loss=loss,
                            intercept=intercept, path_mode="batch")
        return res.coef, res.intercept

    coefs, bs = jax.vmap(fold_fit)(masks)   # (F, k, p), (F, k)

    def fold_eta(coef_f, b_f, mask):
        eta = dot(X, coef_f.T) + b_f[None, :]   # (n, k)
        return eta * (1.0 - mask)[:, None]

    etas = jax.vmap(fold_eta)(coefs, bs, masks)
    return jnp.sum(etas, axis=0)            # (n, k) own-fold decisions


def cv_svm_path(X, y, *, nfolds: int = 10, foldid=None, weights=None,
                Cs=None, nC: int = 20, C_min_ratio: float = 1e-3,
                loss: str = "squared_hinge", intercept: bool = True,
                type_measure: str = "class", maxit: int = 20000,
                eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                rho: float = -1.0, seed: int = 0, fold_mesh=None,
                dtype=jnp.float32) -> CVSVMResult:
    """K-fold CV over the SVM C grid, scored by held-out
    misclassification (``type_measure="class"``) or the hinge /
    squared-hinge loss itself (``"loss"``); glmnet's per-observation
    cvm/cvsd aggregation and one-SE rule (pointing toward SMALLER C =
    stronger regularization)."""
    ysign, _ = _as_sign(y)
    Xd = jnp.asarray(X, dtype)
    n = Xd.shape[0]
    if type_measure not in ("class", "loss"):
        raise ValueError("type_measure must be 'class' or 'loss'")
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

    fit = svm_path(X, y, Cs=Cs, nC=nC, C_min_ratio=C_min_ratio,
                   loss=loss, intercept=intercept, weights=weights,
                   maxit=maxit, eps_abs=eps_abs, eps_rel=eps_rel,
                   rho=rho, dtype=dtype)
    Cs_d = fit.Cs

    masks = jnp.asarray(foldid[None, :] != np.arange(nfolds)[:, None],
                        dtype)
    if fold_mesh is not None:
        from ..models.cv import _shard_folds

        masks = _shard_folds(masks, fold_mesh)
    eta = np.asarray(_cv_svm_core(
        Xd, jnp.asarray(ysign, dtype), masks, w, Cs_d,
        jnp.asarray(rho, dtype), maxit, eps_abs, eps_rel, loss=loss,
        intercept=bool(intercept)))                      # (n, k)

    # foldid < 0 rows train in every fold but are never held out
    # (cv.py's convention): exclude them from scoring — their eta is 0
    # by construction and would count as a misclassification.
    scored = foldid >= 0
    margin = (ysign[:, None] * eta)[scored]
    if type_measure == "class":
        cvraw = (margin <= 0).astype(float)
    else:
        h = np.maximum(0.0, 1.0 - margin)
        cvraw = h if loss == "hinge" else h * h
    ws = np.asarray(w)[scored]
    ws = ws / ws.sum()
    nsc = int(scored.sum())
    cvm = ws @ cvraw
    cvsd = np.sqrt((ws @ (cvraw - cvm) ** 2) / max(nsc - 1, 1))
    imin = int(np.argmin(cvm))
    Cs_np = np.asarray(Cs_d)
    ok = np.flatnonzero(cvm <= cvm[imin] + cvsd[imin])
    return CVSVMResult(Cs=Cs_np, cvm=cvm, cvsd=cvsd,
                       C_min=float(Cs_np[imin]),
                       C_1se=float(Cs_np[ok[-1]]),  # smallest such C
                       fit=fit, foldid=foldid)
