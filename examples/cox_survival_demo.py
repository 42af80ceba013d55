"""Survival analysis end-to-end: the Cox family tour.

Fits an L1 Cox path, cross-validates it (one-pass fold sweep), draws
survival curves from the Breslow baseline, and exercises the two
glmnet survival extensions — stratified baselines (``stratifySurv``)
and start-stop / left-truncated data (``Surv(start, stop, event)``),
including both at once.

Run: ``python examples/cox_survival_demo.py`` (first compiles take
a few minutes; figures land next to this file).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

import admm_tpu

rng = np.random.default_rng(0)
n, p = 400, 20
X = rng.normal(size=(n, p))
beta = np.zeros(p)
beta[:4] = [0.8, -0.6, 0.5, -0.4]

# Right-censored survival times from a proportional-hazards model.
t = rng.exponential(np.exp(-(X @ beta)))
d = (rng.uniform(size=n) < 0.75).astype(float)

# Fit + cross-validate through the glmnet front door ((n, 2) Surv y).
cv = admm_tpu.cv_glmnet(X, np.c_[t, d], family="cox", nfolds=5,
                        nlambda=30)
print(f"cox cv: lambda_min={cv.lambda_min:.4f} "
      f"lambda_1se={cv.lambda_1se:.4f}")
print("active coefficients at lambda_min:",
      int((np.abs(admm_tpu.coef(cv, lam="lambda.min")) > 1e-6).sum()))

# Held-out style assessment + concordance on the training data.
sc = admm_tpu.assess(cv.fit, X, np.c_[t, d])
print(f"deviance range along the path: [{sc['deviance'].min():.1f}, "
      f"{sc['deviance'].max():.1f}]; best C = {sc['C'].max():.3f}")

# Survival curves from the Breslow baseline at lambda.1se.
sf = admm_tpu.survfit_cox(cv, X, t, d)
from admm_tpu.plotting import plot_survfit

ax = plot_survfit(sf, max_curves=25)
ax.set_title("S(t | x) at lambda.1se")
out = os.path.join(os.path.dirname(__file__), "cox_survival.png")
ax.figure.savefig(out, dpi=110)
print("saved", out)

# Stratified baselines: two centers with different baseline hazards.
strata = rng.integers(0, 2, n)
t_s = t * (1.0 + 2.0 * strata)
cv_s = admm_tpu.cv_glmnet(X, np.c_[t_s, d], family="cox",
                          strata=strata, nfolds=5, nlambda=20)
sf_s = admm_tpu.survfit_cox(cv_s, X, t_s, d, strata=strata)
print("stratified: per-stratum event times:",
      {int(k): int(v.time.size) for k, v in sf_s.items()})

# Start-stop (left truncation): subjects enter at start > 0.
start = t * rng.uniform(0.0, 0.6, n)
cv_ss = admm_tpu.cv_glmnet(X, np.c_[start, t, d], family="cox",
                           nfolds=5, nlambda=20)
print(f"start-stop: lambda_min={cv_ss.lambda_min:.4f}")

# Both at once (per-stratum interval risk sets).
fit_both = admm_tpu.glmnet(X, np.c_[start, t_s, d], family="cox",
                           strata=strata, nlambda=10)
print("stratified start-stop path:", np.asarray(fit_both.coef).shape)
