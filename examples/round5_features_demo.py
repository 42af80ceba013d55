"""Round-5 feature tour: penalized quantile regression, the fast
(concomitant) square-root lasso, and the completed robust-PCA family
(partial SVT, missing entries, lambda path, entry-holdout CV).

Run: ``python examples/round5_features_demo.py`` (first compiles
take a minute or two; figures land next to this file).
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

here = os.path.dirname(os.path.abspath(__file__))
rng = np.random.default_rng(0)

# --- Penalized quantile regression: tau x lambda in one program -----
n, p = 600, 30
X = rng.normal(size=(n, p))
beta = np.zeros(p)
beta[:5] = [1.5, -1.0, 0.8, -0.6, 0.4]
# Heteroscedastic, heavy-tailed noise: exactly the regime where the
# conditional quantiles diverge from the conditional mean.
y = X @ beta + (1.0 + 0.5 * np.abs(X[:, 0])) * rng.standard_t(3, size=n)

taus = np.array([0.1, 0.25, 0.5, 0.75, 0.9])
res = admm_tpu.quantile_lasso_path(X, y, tau=taus, nlambda=20)
print("quantile path niter (tau x lambda):")
print(np.asarray(res.niter))

cv = admm_tpu.cv_quantile_lasso_path(X, y, tau=taus, nfolds=5,
                                     nlambda=15)
print("pinball-CV lambda_min per tau:", np.round(cv["lambda_min"], 4))

fig, ax = plt.subplots(1, 2, figsize=(11, 4))
for t in range(len(taus)):
    ax[0].plot(np.log(np.asarray(res.lambdas[t])),
               np.asarray(res.coef[t, :, 0]), label=f"tau={taus[t]}")
ax[0].set_xlabel("log lambda")
ax[0].set_ylabel("coef of x1")
ax[0].set_title("Quantile-lasso paths (first coefficient)")
ax[0].legend(fontsize=8)
for t in range(len(taus)):
    ax[1].plot(np.log(cv["lambdas"][t]), cv["cvm"][t],
               label=f"tau={taus[t]}")
ax[1].set_xlabel("log lambda")
ax[1].set_ylabel("pinball CV loss")
ax[1].set_title("One-pass pinball CV")
ax[1].legend(fontsize=8)
fig.tight_layout()
fig.savefig(os.path.join(here, "round5_quantile.png"), dpi=120)
print("wrote round5_quantile.png")

# --- Square-root lasso: pivotal tuning across noise levels ----------
# The SAME lambda grid works at every sigma (the whole point); the
# concomitant alternation solves each path in a few warm outer steps.
lam_grid = np.geomspace(0.3, 0.01, 15)
for sigma in (0.2, 1.0, 5.0):
    ys = X @ beta + sigma * rng.normal(size=n)
    r = admm_tpu.sqrt_lasso_path(X, ys, lambdas=lam_grid)
    nnz = int((np.asarray(r.coef[7]) != 0).sum())
    print(f"sqrt-lasso sigma={sigma}: support at mid-grid = {nnz} "
          f"(total iters {int(np.asarray(r.niter).sum())})")

# --- Robust PCA, completed -----------------------------------------
m = 300
L0 = rng.normal(size=(m, 5)) @ rng.normal(size=(5, m)) / np.sqrt(5)
S0 = np.zeros((m, m))
mask_c = rng.uniform(size=(m, m)) < 0.06
S0[mask_c] = 6 * rng.choice([-1.0, 1.0], size=mask_c.sum())
M = L0 + S0

# Partial SVT (rank hint) — the large-matrix solver.
dec = admm_tpu.rpca(M, rank=5)
err = np.abs(np.asarray(dec.low_rank) - L0).max() / np.abs(L0).max()
print(f"rpca(rank=5): relative recovery error {err:.1e} "
      f"in {int(dec.niter)} iterations")

# Missing entries: fit on 80%, the low-rank part extends off-mask.
obs = rng.uniform(size=(m, m)) < 0.8
dec_m = admm_tpu.rpca(M, observed=obs, rank=5, maxit=20000)
err_off = (np.abs(np.asarray(dec_m.low_rank) - L0)[~obs].max()
           / np.abs(L0).max())
print(f"masked rpca: off-mask recovery error {err_off:.1e}")

# Entry-holdout CV over the sparsity penalty.
cvr = admm_tpu.cv_rpca(M, nlambda=7, nfolds=4, rank=5, maxit=2000)
star = 1.0 / np.sqrt(m)
print(f"cv_rpca: lambda_min = {cvr.lambda_min:.4f} "
      f"(universal lam* = {star:.4f})")

fig, ax = plt.subplots(figsize=(5.5, 4))
ax.errorbar(np.log(cvr.lambdas), cvr.cvm, yerr=cvr.cvsd, marker="o")
ax.axvline(np.log(star), ls="--", c="gray", label="universal lam*")
ax.axvline(np.log(cvr.lambda_min), ls=":", c="tab:red",
           label="lambda_min")
ax.set_xlabel("log lambda")
ax.set_ylabel("held-out-entry MAE")
ax.set_title("Entry-holdout CV for robust PCA")
ax.legend()
fig.tight_layout()
fig.savefig(os.path.join(here, "round5_rpca_cv.png"), dpi=120)
print("wrote round5_rpca_cv.png")
