"""Golden tests for LAD, Basis Pursuit and the Dantzig selector."""
import numpy as np
import pytest
from scipy.optimize import linprog
from sklearn.linear_model import QuantileRegressor

from admm_tpu.models.bp import bp_fit
from admm_tpu.models.dantzig import dantzig_path
from admm_tpu.models.lad import lad_fit


# ---------------------------------------------------------------------------
# LAD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lad_problem():
    # n >> p keeps the LAD optimum well-determined (small-n median
    # regression has a nearly flat optimum and coefficient comparisons
    # become meaningless); the reference benchmarks at n=1000 too.
    rng = np.random.default_rng(123)
    n, p = 1000, 20
    X = rng.normal(size=(n, p))
    b = rng.uniform(-1, 1, p)
    y = 2.0 + X @ b + 0.5 * rng.normal(size=n)
    return X, y


def test_lad_matches_quantile_regression(lad_problem):
    X, y = lad_problem
    res = lad_fit(X, y, intercept=True, eps_abs=1e-5, eps_rel=1e-5,
                  maxit=20000)
    qr = QuantileRegressor(quantile=0.5, alpha=0.0,
                           solver="highs").fit(X, y)
    # Reference tolerance vs quantreg is ~7e-3 (README.md:327-333).
    np.testing.assert_allclose(np.asarray(res.coef), qr.coef_, atol=7e-3)
    np.testing.assert_allclose(float(res.beta0), qr.intercept_, atol=7e-3)


def test_lad_objective_near_optimal(lad_problem):
    X, y = lad_problem
    res = lad_fit(X, y, intercept=True, eps_abs=1e-5, eps_rel=1e-5,
                  maxit=20000)
    qr = QuantileRegressor(quantile=0.5, alpha=0.0,
                           solver="highs").fit(X, y)
    ours = np.abs(y - X @ np.asarray(res.coef) - float(res.beta0)).sum()
    best = np.abs(y - X @ qr.coef_ - qr.intercept_).sum()
    assert ours <= best * 1.001


def test_lad_no_intercept(lad_problem):
    X, y = lad_problem
    res = lad_fit(X, y, intercept=False, eps_abs=1e-5, eps_rel=1e-5,
                  maxit=20000)
    qr = QuantileRegressor(quantile=0.5, alpha=0.0, fit_intercept=False,
                           solver="highs").fit(X, y)
    ours = np.abs(y - X @ np.asarray(res.coef)).sum()
    best = np.abs(y - X @ qr.coef_).sum()
    assert ours <= best * 1.005
    assert float(res.beta0) == 0.0


# ---------------------------------------------------------------------------
# Basis Pursuit
# ---------------------------------------------------------------------------

def _bp_lp(A, b):
    """Oracle: min ||x||_1 s.t. Ax=b as an LP (x = u - v, u,v >= 0)."""
    n, p = A.shape
    c = np.ones(2 * p)
    A_eq = np.concatenate([A, -A], axis=1)
    res = linprog(c, A_eq=A_eq, b_eq=b, bounds=[(0, None)] * (2 * p),
                  method="highs")
    assert res.success
    return res.x[:p] - res.x[p:]


@pytest.fixture(scope="module")
def bp_problem():
    # BASELINE.json config: n=50 p=100 underdetermined exact recovery.
    rng = np.random.default_rng(123)
    n, p = 50, 100
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    x0 = np.zeros(p)
    idx = rng.choice(p, 8, replace=False)
    x0[idx] = rng.normal(size=8)
    return A, A @ x0, x0


def test_bp_exact_recovery(bp_problem):
    A, b, x0 = bp_problem
    res = bp_fit(A, b, eps_abs=1e-6, eps_rel=1e-6)
    np.testing.assert_allclose(np.asarray(res.coef), x0, atol=1e-3)


def test_bp_matches_lp_oracle(bp_problem):
    A, b, _ = bp_problem
    res = bp_fit(A, b, eps_abs=1e-6, eps_rel=1e-6)
    x_lp = _bp_lp(A, b)
    np.testing.assert_allclose(np.asarray(res.coef), x_lp, atol=1e-3)


def test_bp_feasibility(bp_problem):
    A, b, _ = bp_problem
    res = bp_fit(A, b, eps_abs=1e-6, eps_rel=1e-6)
    np.testing.assert_allclose(A @ np.asarray(res.coef), b, atol=1e-4)


# ---------------------------------------------------------------------------
# Dantzig selector
# ---------------------------------------------------------------------------

def _dantzig_lp(X, y, lam):
    """Oracle LP: min ||b||_1 s.t. ||X'(Xb - y)||_inf <= lam.

    b = u - v with u, v >= 0;  -lam <= X'X(u-v) - X'y <= lam.
    """
    n, p = X.shape
    G = X.T @ X
    Xty = X.T @ y
    c = np.ones(2 * p)
    A_ub = np.concatenate([
        np.concatenate([G, -G], axis=1),
        np.concatenate([-G, G], axis=1),
    ], axis=0)
    b_ub = np.concatenate([lam + Xty, lam - Xty])
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=[(0, None)] * (2 * p),
                  method="highs")
    assert res.success
    return res.x[:p] - res.x[p:]


def test_dantzig_matches_lp_oracle():
    rng = np.random.default_rng(5)
    n, p = 80, 30
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:4] = [1.5, -2.0, 1.0, 0.8]
    y = X @ b + 0.2 * rng.normal(size=n)
    lam_int = 8.0  # internal scale (no standardization => user scale * n)
    lam_user = lam_int / n
    res = dantzig_path(X, y, lambdas=np.array([lam_user]),
                       standardize=False, intercept=False, eps_abs=1e-7,
                       eps_rel=1e-7, maxit=30000)
    ours = np.asarray(res.coef[0])
    oracle = _dantzig_lp(X, y, lam_int)
    np.testing.assert_allclose(ours, oracle, atol=5e-3)


def test_dantzig_constraint_satisfied():
    rng = np.random.default_rng(5)
    n, p = 80, 30
    X = rng.normal(size=(n, p))
    b = np.zeros(p)
    b[:4] = [1.5, -2.0, 1.0, 0.8]
    y = X @ b + 0.2 * rng.normal(size=n)
    lam_user = 0.1
    res = dantzig_path(X, y, lambdas=np.array([lam_user]),
                       standardize=False, intercept=False, eps_abs=1e-7,
                       eps_rel=1e-7, maxit=30000)
    bb = np.asarray(res.coef[0])
    viol = np.abs(X.T @ (X @ bb - y)).max() - lam_user * n
    assert viol <= 1e-2


def test_dantzig_batch_mode_matches_scan():
    rng = np.random.default_rng(5)
    n, p = 200, 30
    b = np.zeros(p)
    b[:5] = rng.normal(size=5)
    X = rng.normal(size=(n, p))
    y = X @ b + 0.2 * rng.normal(size=n)
    lams = np.geomspace(0.5, 0.02, 8)
    from admm_tpu.models.dantzig import dantzig_path

    scan = dantzig_path(X, y, lambdas=lams, path_mode="scan")
    batch = dantzig_path(X, y, lambdas=lams, path_mode="batch")
    np.testing.assert_allclose(np.asarray(batch.coef),
                               np.asarray(scan.coef), atol=5e-3)


def test_dantzig_path_runs():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(60, 15))
    y = X @ np.concatenate([np.ones(3), np.zeros(12)]) \
        + 0.1 * rng.normal(size=60)
    res = dantzig_path(X, y, nlambda=10, maxit=5000)
    assert np.asarray(res.coef).shape == (10, 15)
    np.testing.assert_allclose(np.asarray(res.coef[0]), 0.0, atol=1e-5)


def test_bp_batch_matches_serial():
    """Many right-hand sides as batched lanes == m serial solves."""
    from admm_tpu.models.bp import bp_fit, bp_fit_batch

    rng = np.random.default_rng(31)
    n, p, m, k = 80, 200, 5, 10
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    X0 = np.zeros((m, p))
    for i in range(m):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
    B = X0 @ A.T

    batch = bp_fit_batch(A, B, eps_abs=1e-6, eps_rel=1e-6)
    assert batch.coef.shape == (m, p)
    for i in range(m):
        ser = bp_fit(A, B[i], eps_abs=1e-6, eps_rel=1e-6)
        np.testing.assert_allclose(np.asarray(batch.coef[i]),
                                   np.asarray(ser.coef), atol=1e-4)
        np.testing.assert_allclose(np.asarray(batch.coef[i]), X0[i],
                                   atol=1e-3)
        assert abs(int(batch.niter[i]) - int(ser.niter)) <= 1


# ---------------------------------------------------------------------------
# Quantile regression (extension: the LAD engine with the asymmetric
# check-loss prox; admm_tpu.quantile_fit)
# ---------------------------------------------------------------------------

def test_quantile_tau_half_equals_lad():
    """tau = 0.5 must reproduce lad_fit exactly (same iterates: the
    doubled check loss is |r| and the asymmetric prox degenerates to the
    symmetric soft-threshold)."""
    from admm_tpu.models.lad import lad_fit, quantile_fit

    rng = np.random.default_rng(21)
    n, p = 300, 20
    X = rng.normal(size=(n, p))
    y = X @ rng.uniform(size=p) + rng.standard_cauchy(n) * 0.5
    a = lad_fit(X, y)
    b = quantile_fit(X, y, tau=0.5)
    np.testing.assert_allclose(np.asarray(a.coef), np.asarray(b.coef),
                               rtol=0, atol=1e-7)
    assert abs(int(a.niter) - int(b.niter)) <= 1


@pytest.mark.parametrize("tau", [0.25, 0.75])
def test_quantile_matches_sklearn(tau):
    """Oracle: sklearn QuantileRegressor (exact LP solver) at
    off-median quantiles, intercept included."""
    from sklearn.linear_model import QuantileRegressor

    from admm_tpu.models.lad import quantile_fit

    rng = np.random.default_rng(22)
    n, p = 400, 10
    X = rng.normal(size=(n, p))
    b = rng.uniform(size=p)
    y = 1.0 + X @ b + rng.gumbel(size=n)  # asymmetric noise
    r = quantile_fit(X, y, tau=tau, eps_abs=1e-6, eps_rel=1e-6)
    sk = QuantileRegressor(quantile=tau, alpha=0.0, fit_intercept=True,
                           solver="highs").fit(X, y)

    def pinball(b0, coef):
        res = y - b0 - X @ coef
        return np.sum(res * (tau - (res < 0)))

    ours = pinball(float(r.beta0), np.asarray(r.coef))
    theirs = pinball(sk.intercept_, sk.coef_)
    # The LP optimum is the gold standard; we must be within a hair of
    # it (ties in LP vertices allow small coefficient differences).
    assert ours <= theirs * (1.0 + 1e-3)
    np.testing.assert_allclose(np.asarray(r.coef), sk.coef_, atol=5e-2)


def test_quantile_validates_tau():
    from admm_tpu.models.lad import quantile_fit

    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="tau"):
        quantile_fit(rng.normal(size=(30, 3)), rng.normal(size=30),
                     tau=1.5)
