"""The XLA solver paths against float64 numpy/scipy references.

These are the paths every backend runs: the tall and wide lasso/enet
lanes, LAD, batched BP and the fixed-majorizer GLM lanes.  Each case
solves in float32 and is held to an independent float64 check (KKT
conditions, or a linear program); the batched-lane solve is also held to
the warm-started scan, lane by lane to solo solves (the batching
reorders float accumulation, so iterations may differ by one), and the
scan's float32 iteration total to its float64 twin (within 10%).
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from admm_tpu.data.standardize import standardize
from admm_tpu.linalg import dot, gram, spectral_radius_sym
from admm_tpu.models.bp import bp_fit, bp_fit_batch
from admm_tpu.models.glm import binomial, glm_lasso_path, huber
from admm_tpu.models.lad import lad_fit
from admm_tpu.models.lasso import (_solve_path_tall, _solve_path_tall_batch,
                                   _solve_path_wide, _solve_path_wide_batch)

EPS = 1e-5
MAXIT = 4000


def _tall_problem(dtype=jnp.float32):
    rng = np.random.default_rng(3)
    n, p, k = 200, 40, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.4)
    y = 1.0 + X @ b + 0.3 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, dtype), jnp.asarray(y, dtype),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    ilams = jnp.asarray(np.geomspace(lam0, lam0 * 1e-3, k), dtype)
    # The batch engine's auto-rho comes from the first lambda; solo and
    # scan solves are given the same rho so their iterates are comparable.
    rho = float(np.cbrt(float(spectral_radius_sym(gram(Xs))))
                * float(ilams[0]) ** (2.0 / 3.0))
    return Xs, ys, ilams, rho


def _wide_problem(dtype=jnp.float32):
    rng = np.random.default_rng(11)
    n, p, k = 60, 150, 9
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:12] = rng.normal(size=12)
    y = X @ b + 0.2 * rng.normal(size=n)
    Xs, ys, _ = standardize(jnp.asarray(X, dtype), jnp.asarray(y, dtype),
                            standardize_x=True, intercept=True)
    lam0 = float(jnp.max(jnp.abs(dot(Xs.T, ys))))
    # The first lambda sits above lambda0: the early exit must give zero.
    ilams = jnp.asarray(np.geomspace(lam0 * 1.1, lam0 * 1e-2, k), dtype)
    return Xs, ys, ilams, -1.0


def _glm_problem(family):
    rng = np.random.default_rng(51)
    n, p = 300, 16
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:4] = [1.5, -2.0, 1.0, 0.5]
    if family == "binomial":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ b))))
    else:
        y = X @ b + 0.3 * rng.normal(size=n)
    return X, y.astype(np.float32)


def _bp_problem():
    rng = np.random.default_rng(12)
    n, p, k, m = 60, 160, 6, 5
    X0 = np.zeros((m, p))
    for i in range(m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    A = (rng.normal(size=(n, p)) / np.sqrt(n)).astype(np.float32)
    B = (X0 @ A.astype(np.float64).T).astype(np.float32)
    return A, B, X0


# ---------------------------------------------------------------------------
# float64 references
# ---------------------------------------------------------------------------

def _kkt(grad, b, lam, alpha):
    """Max violation, relative to lam, of the KKT conditions of a smooth
    loss with gradient ``-grad`` plus ``lam (alpha|b|_1 + (1-alpha)/2
    |b|^2)``; rows are lambdas."""
    g = grad - (lam * (1 - alpha))[:, None] * b
    t = (lam * alpha)[:, None]
    viol = np.where(b != 0, np.abs(g - t * np.sign(b)),
                    np.maximum(np.abs(g) - t, 0.0))
    return float((viol / t).max())


def _gaussian_kkt(Xs, ys, ilams, coefs, alpha):
    """Internal objective 1/2|ys - Xs b|^2 + ilam * penalty(b)."""
    X = np.asarray(Xs, np.float64)
    b = np.asarray(coefs, np.float64)
    grad = (np.asarray(ys, np.float64)[:, None] - X @ b.T).T @ X
    return _kkt(grad, b, np.asarray(ilams, np.float64), alpha)


def _glm_kkt(X, y, res, family):
    X = np.asarray(X, np.float64)
    mx, sx = X.mean(axis=0), X.std(axis=0)
    Xs = (X - mx) / sx
    coef = np.asarray(res.coef, np.float64)
    eta = np.asarray(res.beta0, np.float64)[:, None] + coef @ X.T
    y = np.asarray(y, np.float64)[None, :]
    if family == "binomial":
        r = y - 1.0 / (1.0 + np.exp(-eta))
    else:
        r = np.clip(y - eta, -1.345, 1.345)
    lam = np.asarray(res.lambdas, np.float64)
    n = X.shape[0]
    viol = _kkt(r @ Xs / n, coef * sx[None, :], lam, 1.0)
    # The unpenalized intercept zeroes the mean score.
    return max(viol, float((np.abs(r.mean(axis=1)) / lam).max()))


def _lp_l1(A_eq, b_eq, n_free):
    """min sum of the last variables (>= 0) s.t. A_eq v = b_eq; the first
    ``n_free`` variables are free."""
    m = A_eq.shape[1] - n_free
    res = linprog(np.concatenate([np.zeros(n_free), np.ones(m)]),
                  A_eq=A_eq, b_eq=b_eq,
                  bounds=[(None, None)] * n_free + [(0, None)] * m,
                  method="highs")
    assert res.status == 0, res.message
    return res.x


# ---------------------------------------------------------------------------
# Cases: each returns what both tests need
# ---------------------------------------------------------------------------

def _lasso_case(regime, alpha):
    def run():
        make = _tall_problem if regime == "tall" else _wide_problem
        Xs, ys, ilams, rho = make()
        if regime == "tall":
            batch = lambda lams, X=Xs, y=ys: _solve_path_tall_batch(
                X, y, lams, rho, MAXIT, EPS, EPS, alpha)
            scan = lambda X, y, lams: _solve_path_tall(
                X, y, lams, rho, MAXIT, EPS, EPS, alpha)
        else:
            batch = lambda lams, X=Xs, y=ys: _solve_path_wide_batch(
                X, y, lams, rho, MAXIT, EPS, EPS, alpha, False)
            scan = lambda X, y, lams: _solve_path_wide(
                X, y, lams, rho, MAXIT, EPS, EPS, alpha, False)
        cb, nb, _ = batch(ilams)
        cs, ns, _ = scan(Xs, ys, ilams)
        X64, y64, l64, _ = make(jnp.float64)
        _, ns64, _ = scan(X64, y64, l64)
        solo = [int(batch(ilams[i:i + 1])[1][0])
                for i in range(ilams.shape[0])]
        kkt = max(_gaussian_kkt(Xs, ys, ilams, cb, alpha),
                  _gaussian_kkt(Xs, ys, ilams, cs, alpha))
        if regime == "wide" and alpha == 1.0:
            # Above the KKT boundary the early exit gives exact zeros
            # (for alpha < 1 the boundary is lambda0 / alpha).
            assert np.abs(np.asarray(cb)[0]).max() == 0.0
        return dict(ref=kkt, ref_tol=2e-2, batch=cb, scan=cs,
                    niter_batch=nb, niter_solo=solo, niter_scan=ns,
                    niter_scan64=ns64, gap_tol=2e-3)
    return run


def _glm_case(family):
    def run():
        X, y = _glm_problem(family)
        fam = binomial() if family == "binomial" else huber(1.345)
        kw = dict(nlambda=6, hessian="fixed", eps_abs=EPS, eps_rel=EPS,
                  dtype=jnp.float32)
        rb = glm_lasso_path(X, y, fam, path_mode="batch", **kw)
        rs = glm_lasso_path(X, y, fam, path_mode="scan", **kw)
        kw64 = dict(kw, dtype=jnp.float64)
        rs64 = glm_lasso_path(X, y, fam, path_mode="scan", **kw64)
        lams = np.asarray(rb.lambdas)
        solo = [int(glm_lasso_path(X, y, fam, path_mode="batch",
                                   lambdas=lams[i:i + 1],
                                   **dict(kw, nlambda=1)).niter[0])
                for i in range(lams.shape[0])]
        kkt = max(_glm_kkt(X, y, rb, family), _glm_kkt(X, y, rs, family))
        return dict(ref=kkt, ref_tol=5e-2, batch=rb.coef, scan=rs.coef,
                    niter_batch=rb.niter, niter_solo=solo,
                    niter_scan=rs.niter, niter_scan64=rs64.niter,
                    gap_tol=2e-3)
    return run


def _bp_case():
    A, B, X0 = _bp_problem()
    rb = bp_fit_batch(A, B, dtype=jnp.float32)
    solo = [bp_fit(A, B[i], dtype=jnp.float32) for i in range(B.shape[0])]
    n, p = A.shape
    A64 = A.astype(np.float64)
    v = _lp_l1(np.hstack([A64, -A64]), B[0].astype(np.float64), 0)
    err = max(float(np.abs(np.asarray(rb.coef) - X0).max()),
              float(np.abs(np.asarray(rb.coef[0]) - (v[:p] - v[p:])).max()))
    return dict(ref=err, ref_tol=2.11e-3, batch=rb.coef,
                scan=np.stack([np.asarray(s.coef) for s in solo]),
                niter_batch=rb.niter,
                niter_solo=[int(s.niter) for s in solo], gap_tol=2e-3)


def _lad_case():
    rng = np.random.default_rng(8)
    n, p = 300, 20
    X = rng.normal(size=(n, p))
    y = X @ rng.normal(size=p) + rng.standard_t(2, size=n)
    res = lad_fit(X.astype(np.float32), y.astype(np.float32),
                  intercept=False, dtype=jnp.float32)
    v = _lp_l1(np.hstack([X, np.eye(n), -np.eye(n)]), y, p)
    coef = np.asarray(res.coef, np.float64)
    obj = np.abs(y - X @ coef).sum()
    obj_ref = np.abs(y - X @ v[:p]).sum()
    assert obj <= obj_ref * (1 + 1e-4)
    return dict(ref=float(np.abs(coef - v[:p]).max()), ref_tol=7e-3)


CASES = {
    "tall": _lasso_case("tall", 1.0),
    "tall_enet": _lasso_case("tall", 0.6),
    "wide": _lasso_case("wide", 1.0),
    "wide_enet": _lasso_case("wide", 0.6),
    "bp": _bp_case,
    "logistic": _glm_case("binomial"),
    "huber": _glm_case("huber"),
    "lad": _lad_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_path_matches_f64_reference(case):
    out = CASES[case]()
    assert out["ref"] <= out["ref_tol"], (case, out["ref"])


@pytest.mark.parametrize("case", sorted(set(CASES) - {"lad"}))
def test_xla_batch_lanes_match_scan_and_solo(case):
    out = CASES[case]()
    gap = np.abs(np.asarray(out["batch"]) - np.asarray(out["scan"])).max()
    assert gap <= out["gap_tol"], (case, gap)
    nb = np.asarray(out["niter_batch"])
    assert np.abs(nb - np.asarray(out["niter_solo"])).max() <= 1, case
    if "niter_scan64" in out:
        t32 = int(np.asarray(out["niter_scan"]).sum())
        t64 = int(np.asarray(out["niter_scan64"]).sum())
        assert abs(t32 - t64) <= 0.1 * t64, (case, t32, t64)
