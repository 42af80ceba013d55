"""The round-2 model families: fused lasso, trend filtering, sparse
logistic regression, and weighted observations.

All extensions beyond the reference's five gaussian models, running on
whatever backend is default.  Saves PNGs next to this file.

Run:  python examples/new_families_demo.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import matplotlib                                  # noqa: E402
matplotlib.use("Agg")
import matplotlib.pyplot as plt                    # noqa: E402

import admm_tpu                                    # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
rng = np.random.default_rng(7)

# --- Fused lasso: denoise a piecewise-constant signal -------------------
n = 300
truth = np.concatenate([np.zeros(100), 2.0 * np.ones(100),
                        0.5 * np.ones(100)])
y = truth + 0.35 * rng.normal(size=n)
fit = admm_tpu.fused_lasso_path(np.eye(n), y, lambdas=np.array([0.02]),
                                intercept=False)
den = np.asarray(fit.coef[0])
print(f"fused lasso: {int(fit.niter[0])} iterations, "
      f"max|fit - truth| = {np.abs(den - truth).max():.3f}")

# --- Trend filtering: a piecewise-linear trend --------------------------
t = np.arange(n, dtype=float)
trend = np.where(t < 150, 0.02 * t, 3.0 - 0.015 * (t - 150))
y2 = trend + 0.25 * rng.normal(size=n)
fit2 = admm_tpu.fused_lasso_path(np.eye(n), y2, order=2,
                                 lambdas=np.array([0.05]),
                                 intercept=False)
tf = np.asarray(fit2.coef[0])

fig, axes = plt.subplots(1, 2, figsize=(11, 3.5))
axes[0].plot(y, ".", ms=2, alpha=0.4, label="noisy")
axes[0].plot(den, lw=2, label="fused lasso")
axes[0].plot(truth, "--", lw=1, label="truth")
axes[0].set_title("Fused lasso (order-1 generalized lasso)")
axes[0].legend()
axes[1].plot(y2, ".", ms=2, alpha=0.4)
axes[1].plot(tf, lw=2, label="trend filter (order 2)")
axes[1].plot(trend, "--", lw=1, label="truth")
axes[1].set_title("Linear trend filtering")
axes[1].legend()
fig.tight_layout()
fig.savefig(os.path.join(HERE, "genlasso_demo.png"), dpi=110)
print("wrote genlasso_demo.png")

# --- Sparse logistic regression with CV ---------------------------------
n2, p = 600, 40
b = np.zeros(p)
b[:6] = rng.uniform(1.0, 2.0, 6) * rng.choice([-1, 1], 6)
X = rng.normal(size=(n2, p))
ylab = (rng.uniform(size=n2)
        < 1 / (1 + np.exp(-(0.3 + X @ b)))).astype(float)
cv = admm_tpu.cv_logistic_path(X, ylab, nfolds=5, nlambda=25)
i = int(np.argmin(np.abs(cv.lambdas - cv.lambda_min)))
sel = np.flatnonzero(np.abs(np.asarray(cv.fit.coef[i])) > 1e-6)
print(f"logistic CV: lambda_min = {cv.lambda_min:.4f}, "
      f"selected support = {sel.tolist()} (truth: 0..5)")

# --- Weighted observations (see tests/test_weights.py for semantics) ---
from admm_tpu.models.lasso import lasso_path  # noqa: E402

w = np.where(np.arange(n2) < 100, 5.0, 1.0)   # upweight the first block
yw = X @ b + 0.5 * rng.normal(size=n2)
fitw = lasso_path(X, yw, nlambda=10, weights=w)
print(f"weighted lasso path: niter = {np.asarray(fitw.niter).tolist()}")

# --- GLM family OBJECTS (glmnet 4.x's family= path) ---------------------
# Alternative links / extra likelihoods plug into the same engine:
# probit and cloglog binomial links, Gamma(log), negative binomial --
# or roll your own GLMFamily from grad/IRLS hooks.
from scipy.special import ndtr  # noqa: E402

yp = (rng.uniform(size=n2) < ndtr(0.3 + X @ b)).astype(float)
fitp = admm_tpu.glmnet(X, yp, family=admm_tpu.binomial_probit(),
                       nlambda=12)
prob = admm_tpu.predict(fitp, X[:4], lam=float(fitp.lambdas[-1]),
                        type="response", family=admm_tpu.binomial_probit())
print(f"probit link: P(y=1|x) for 4 rows = {np.round(prob, 3).tolist()}")

yg = rng.gamma(2.0, np.exp(0.2 + 0.5 * X[:, 0]) / 2.0) + 1e-6
cvg = admm_tpu.cv_glmnet(X, yg, family=admm_tpu.gamma_log(),
                         nfolds=4, nlambda=12, seed=0)
print(f"gamma(log) CV: lambda_min = {cvg.lambda_min:.4f}")
