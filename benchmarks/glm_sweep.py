"""GLM performance decision sweep.

Measures, on the current backend (which the output names), the
30-lambda GLM paths at 2000 x 200 across the design matrix:

  * hessian: "exact" (per-step (q, q) Hessian build + Cholesky) vs
    "fixed" (one-time-factorized curvature majorizer — bounded-curvature
    families only);
  * path_mode: "scan" (warm-started sequential) vs "batch" (lambda
    lanes);
  * rho: {0.3, 1, 3, 10} on the shipped (fastest) config per family.

Writes benchmarks/glm_sweep.json; the decision table lives in DESIGN.md
("GLM tier").  Timing = the repo's two-point amortized protocol
(run_baselines.amortized_ms).

Run:  python benchmarks/glm_sweep.py [--fast]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.run_baselines import amortized_ms  # noqa: E402


def problems(n=2000, p=200, seed=123):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:10] = rng.uniform(0.5, 1.5, 10)
    eta = 0.3 + X @ b * 0.3
    return X, {
        "logistic": (rng.uniform(size=n) < 1 / (1 + np.exp(-eta)))
        .astype(np.float32),
        "huber": (eta + 0.3 * rng.normal(size=n)).astype(np.float32),
        "poisson": rng.poisson(np.exp(np.clip(eta * 0.3, None, 3.0)))
        .astype(np.float32),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from admm_tpu.models.glm import _glm_path, binomial, huber, poisson

    fams = {"logistic": binomial(), "huber": huber(1.345),
            "poisson": poisson()}
    X, ys = problems()
    Xj = jnp.asarray(X)
    dev = jax.devices()[0].platform
    results = {"device": dev, "problem": "2000x200, 30 lambdas"}

    def one_factory(fam, mode, hessian, rho):
        def one(i, Xj, yj):
            XX = Xj * (1.0 + 1e-7 * (i + 1).astype(Xj.dtype))
            r = _glm_path(XX, yj, 30, 1e-2, None, rho, 10000,
                          1e-5, 1e-5, 1.0, family=fam,
                          standardize_x=True, intercept=True,
                          path_mode=mode, hessian=hessian)
            return jnp.sum(r.coef) + jnp.sum(r.niter)
        return one

    def niter_total(fam, mode, hessian, rho, yj):
        r = _glm_path(Xj, yj, 30, 1e-2, None, rho, 10000, 1e-5, 1e-5,
                      1.0, family=fam, standardize_x=True,
                      intercept=True, path_mode=mode, hessian=hessian)
        return int(np.asarray(r.niter).sum())

    # --- hessian x path_mode matrix at the default rho -------------------
    grid = {}
    for name, fam in fams.items():
        yj = jnp.asarray(ys[name])
        modes = [("exact", "scan"), ("exact", "batch")]
        if fam.curvature_bound is not None:
            modes += [("fixed", "scan"), ("fixed", "batch")]
        for hess, mode in modes:
            ks = ((1, 3) if hess == "exact" else (2, 8))
            if args.fast:
                ks = (1, 2) if hess == "exact" else (1, 4)
            ms = amortized_ms(one_factory(fam, mode, hess, -1.0), *ks,
                              args=(Xj, yj))
            it = niter_total(fam, mode, hess, -1.0, yj)
            grid[f"{name}/{hess}/{mode}"] = dict(
                ms=round(ms, 3), niter_total=it)
            print(f"{name:9s} {hess:5s} {mode:5s}: {ms:9.3f} ms  "
                  f"(total iters {it})", flush=True)
    results["grid"] = grid

    # --- rho sweep on the fastest available config per family -----------
    rho_rows = {}
    for name, fam in fams.items():
        yj = jnp.asarray(ys[name])
        hess = "fixed" if fam.curvature_bound is not None else "exact"
        best = min((v["ms"], k) for k, v in grid.items()
                   if k.startswith(f"{name}/{hess}/"))[1]
        mode = best.split("/")[2]
        for rho in (0.3, 1.0, 3.0, 10.0):
            ks = (2, 8) if hess == "fixed" else (1, 3)
            if args.fast:
                ks = (1, 4) if hess == "fixed" else (1, 2)
            ms = amortized_ms(one_factory(fam, mode, hess, rho), *ks,
                              args=(Xj, yj))
            it = niter_total(fam, mode, hess, rho, yj)
            rho_rows[f"{name}/{hess}/{mode}/rho={rho}"] = dict(
                ms=round(ms, 3), niter_total=it)
            print(f"{name:9s} {hess:5s} {mode:5s} rho={rho:5.1f}: "
                  f"{ms:9.3f} ms (total iters {it})", flush=True)
    results["rho_sweep"] = rho_rows

    # --- oracle check: fastest logistic config vs sklearn saga ----------
    try:
        from sklearn.linear_model import LogisticRegression

        n = X.shape[0]
        lam = 0.02
        r = _glm_path(Xj, jnp.asarray(ys["logistic"]), 1, 1e-2,
                      jnp.asarray([lam], jnp.float32), -1.0, 10000,
                      1e-7, 1e-7, 1.0, family=fams["logistic"],
                      standardize_x=False, intercept=True,
                      path_mode="batch", hessian="fixed")
        sk = LogisticRegression(penalty="l1", C=1.0 / (n * lam),
                                solver="saga", tol=1e-8, max_iter=50000,
                                fit_intercept=True)
        sk.fit(X, ys["logistic"])
        gap = float(np.abs(np.asarray(r.coef)[0] - sk.coef_[0]).max())
        results["sklearn_saga_coef_gap"] = gap
        print(f"sklearn saga agreement (fixed/batch): max gap {gap:.2e}",
              flush=True)
    except Exception as e:  # oracle is optional on minimal images
        results["sklearn_saga_coef_gap"] = f"skipped: {e}"

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "glm_sweep.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
