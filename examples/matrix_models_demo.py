"""Round-4 matrix-variable families: graphical lasso, linear SVM,
robust PCA.

Run: python examples/matrix_models_demo.py   (CPU or GPU)
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import admm_tpu  # noqa: E402

rng = np.random.default_rng(0)

# --- Graphical lasso: recover a sparse conditional-independence graph
print("== graphical lasso ==")
p, n = 20, 1500
prec0 = np.eye(p)
for i in range(p - 1):           # chain graph
    prec0[i, i + 1] = prec0[i + 1, i] = 0.35
X = rng.multivariate_normal(np.zeros(p), np.linalg.inv(prec0), size=n)

cv = admm_tpu.cv_glasso_path(X, nfolds=5, nlambda=15)
print(f"lambda_min={cv.lambda_min:.4f}  lambda_1se={cv.lambda_1se:.4f}")
i = int(np.argmin(np.abs(cv.lambdas - cv.lambda_min)))
P = np.asarray(cv.fit.precision[i])
true_edges = {(a, a + 1) for a in range(p - 1)}
found = {(a, b) for a in range(p) for b in range(a + 1, p)
         if P[a, b] != 0}
tp = len(true_edges & found)
print(f"edges: {tp}/{len(true_edges)} true recovered, "
      f"{len(found) - tp} false at lambda_min")

# --- Linear SVM: the whole C grid as lanes, CV-selected
print("\n== linear SVM ==")
Xc = rng.normal(size=(400, 15))
yc = (Xc @ rng.normal(size=15) + 0.3 * rng.normal(size=400) > 0
      ).astype(int)
cvs = admm_tpu.cv_svm_path(Xc, yc, nfolds=5, nC=12)
print(f"C_min={cvs.C_min:.4f}  CV error={cvs.cvm.min():.3f}")
j = int(np.argmin(np.abs(cvs.Cs - cvs.C_min)))
w = np.asarray(cvs.fit.coef[j]); b = float(cvs.fit.intercept[j])
acc = (((Xc @ w + b) > 0).astype(int) == yc).mean()
print(f"train accuracy at C_min: {acc:.3f}")

# --- SLOPE: FDR-controlled adaptive thresholds
print("\n== SLOPE ==")
Xs = rng.normal(size=(300, 40))
bs = np.zeros(40); bs[:4] = [3, -2, 1.5, 1]
ys = Xs @ bs + rng.normal(size=300)
cvsl = admm_tpu.cv_slope_path(Xs, ys, nfolds=5, nlambda=10, q=0.1)
i = int(np.argmin(np.abs(cvsl.lambdas - cvsl.lambda_1se)))
sel = np.flatnonzero(np.asarray(cvsl.fit.coef[i]))
print(f"selected support at lambda_1se: {sel.tolist()} "
      f"(truth: [0, 1, 2, 3])")

# --- Matrix completion: fill in a low-rank matrix from 50% of entries
print("\n== matrix completion ==")
Lmc = rng.normal(size=(60, 3)) @ rng.normal(size=(3, 50))
obs = rng.uniform(size=Lmc.shape) < 0.5
Lhat, ni = admm_tpu.matrix_complete(np.where(obs, Lmc, 0.0), obs)
print(f"completion max err: {np.abs(np.asarray(Lhat) - Lmc).max():.2e} "
      f"from {obs.mean():.0%} of entries  niter={int(ni)}")

# --- Robust PCA: separate a corrupted low-rank matrix exactly
print("\n== robust PCA ==")
L0 = rng.normal(size=(80, 3)) @ rng.normal(size=(3, 60))
S0 = np.zeros((80, 60))
mask = rng.uniform(size=S0.shape) < 0.06
S0[mask] = 10 * rng.choice([-1.0, 1.0], size=mask.sum())
dec = admm_tpu.rpca(L0 + S0)
errL = np.abs(np.asarray(dec.low_rank) - L0).max()
print(f"low-rank recovery max err: {errL:.2e}  "
      f"(rank {np.linalg.matrix_rank(np.asarray(dec.low_rank), tol=1e-3)}"
      f", {int((np.asarray(dec.sparse) != 0).sum())} corruptions found, "
      f"{int(mask.sum())} planted)  niter={int(dec.niter)}")
