"""FLOP-account the headline rows against the device's measured matmul
ceiling (DESIGN.md "Roofline").

For the matmul-bound rows (flagship path, one-pass CV, sqrt-lasso) the
model counts the dominant dense-linalg FLOPs from the OBSERVED
iteration counts; for the decomposition/prox-bound rows (glasso, SLOPE)
it attributes wall time to the dominant op by measuring that op alone.
The ceiling is a 4096^3 f32 matmul at Precision.HIGHEST — the same
precision every solve-path matmul uses (CLAUDE.md rule), i.e. the
realistic upper bound, not the bf16 peak.

Run from the repo root: ``python benchmarks/roofline.py``.
"""
import json
import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.run_baselines import amortized_ms  # noqa: E402
from admm_tpu.linalg import dot  # noqa: E402


def matmul_ceiling_tflops():
    k = 4096
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(k, k)), jnp.float32)
    B = jnp.asarray(rng.normal(size=(k, k)), jnp.float32)

    def one(i, A, B):
        return jnp.sum(dot(A * (1.0 + 1e-6 * (i + 1).astype(A.dtype)),
                           B))

    ms = amortized_ms(one, 5, 25, args=(A, B))
    return 2.0 * k ** 3 / (ms * 1e-3) / 1e12, ms


def flagship_row(out, ceiling):
    """10000 x 1000, 100 lambdas, warm scan (the BASELINE flagship)."""
    from admm_tpu.models.lasso import _path_auto

    rng = np.random.default_rng(0)
    n, p, L = 10000, 1000, 100
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p, np.float32)
    b[:100] = rng.normal(size=100).astype(np.float32)
    y = X @ b + rng.normal(size=n).astype(np.float32)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    kw = dict(standardize_x=True, intercept=True, enet_scale=False,
              path_mode="scan")
    res = _path_auto(Xj, yj, L, 1e-4, jnp.float32(-1.0), 10000, 1e-5,
                     1e-5, 1.0, **kw)
    iters = int(np.asarray(res.niter).sum())

    def one(i, Xj, yj):
        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        r = _path_auto(Xj, yy, L, 1e-4, jnp.float32(-1.0), 10000, 1e-5,
                       1e-5, 1.0, **kw)
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ms = amortized_ms(one, 2, 10, args=(Xj, yj))
    # Dominant FLOPs: gram 2np^2, ridge inverse ~2.3p^3, per-iteration
    # Minv matvec 2p^2.
    flops = 2 * n * p ** 2 + 2.3 * p ** 3 + iters * 2 * p ** 2
    out["flagship_scan_10000x1000_100lam"] = dict(
        ms=round(ms, 3), total_iters=iters, model_gflop=round(flops / 1e9, 1),
        achieved_tflops=round(flops / (ms * 1e-3) / 1e12, 2),
        pct_of_ceiling=round(100 * flops / (ms * 1e-3) / 1e12 / ceiling, 1))
    return Xj, yj


def cv_row(out, ceiling, Xj, yj):
    """One-pass 10-fold CV on the flagship shape: where do the ~200 ms
    go?  The vmapped fold sweep's while_loop runs until the SLOWEST of
    the F*L cold lanes converges and every frozen lane still computes
    (then discards) its update — so the work model is
    iters_max * F * L * 2p^2, not sum(niter)."""
    from admm_tpu.models.cv import _gaussian_fold_etas
    from admm_tpu.models.lasso import _path_auto, _path_user

    n, p = Xj.shape
    F, L = 10, 100
    full = _path_auto(Xj, yj, L, 1e-4, jnp.float32(-1.0), 10000, 1e-5,
                      1e-5, 1.0, standardize_x=True, intercept=True,
                      enet_scale=False, path_mode="scan")
    lams = full.lambdas
    rng = np.random.default_rng(0)
    foldid = rng.permutation(np.arange(n) % F).astype(np.int32)
    masks = jnp.asarray(
        (foldid[None, :] != np.arange(F)[:, None]).astype(np.float32))

    # Per-fold per-lane iteration counts (the cold batched protocol the
    # sweep runs): max over ALL lanes is the loop's trip count.
    niters = []
    for f in range(F):
        rf = _path_user(Xj, yj, lams, jnp.float32(-1.0), 10000, 1e-5,
                        1e-5, 1.0, masks[f], None, None,
                        standardize_x=True, intercept=True,
                        enet_scale=False, path_mode="batch")
        niters.append(np.asarray(rf.niter))
    niters = np.stack(niters)

    def one(i, Xj, yj, masks):
        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        etas = _gaussian_fold_etas(Xj, yy, lams, masks,
                                   jnp.asarray(foldid), -1.0, 10000,
                                   1e-5, 1e-5, 1.0,
                                   standardize_x=True, intercept=True,
                                   enet_scale=False)
        return jnp.sum(etas)

    ms = amortized_ms(one, 2, 8, args=(Xj, yj, masks))
    it_max = int(niters.max())
    flops = (F * (2 * n * p ** 2 + 2.3 * p ** 3)     # grams + inverses
             + it_max * F * L * 2 * p ** 2           # frozen lanes burn
             + F * 2 * L * p * n)                    # eta prediction
    out["cv_onepass_10fold_10000x1000_100lam"] = dict(
        ms=round(ms, 1), iters_max_lane=it_max,
        iters_mean_lane=round(float(niters.mean()), 1),
        model_gflop=round(flops / 1e9, 1),
        achieved_tflops=round(flops / (ms * 1e-3) / 1e12, 2),
        pct_of_ceiling=round(100 * flops / (ms * 1e-3) / 1e12 / ceiling, 1),
        note="frozen-lane burn: work scales with the max lane, "
             f"{round(it_max / float(niters.mean()), 1)}x the mean")


def sqrt_row(out, ceiling):
    from admm_tpu.models.sqrtlasso import _sqrt_path_dev

    rng = np.random.default_rng(0)
    n, p, L = 10000, 500, 30
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p, np.float32)
    b[:25] = rng.normal(size=25).astype(np.float32) * 2
    y = X @ b + rng.normal(size=n).astype(np.float32)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    res = _sqrt_path_dev(Xj, yj, L, 1e-2, None, jnp.float32(-1.0),
                         10000, 1e-6, 1e-6, standardize_x=True,
                         intercept=True, path_mode="batch")
    it_max = int(np.asarray(res.niter).max())

    def one(i, Xj, yj):
        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        r = _sqrt_path_dev(Xj, yy, L, 1e-2, None, jnp.float32(-1.0),
                           10000, 1e-6, 1e-6, standardize_x=True,
                           intercept=True, path_mode="batch")
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ms = amortized_ms(one, 2, 10, args=(Xj, yj))
    # Batched lanes: it_max iterations x L lanes x (Minv matvec 2p^2);
    # each sigma step adds an (L, p) x (p, n) residual matmul.
    flops = (2 * n * p ** 2 + 2.3 * p ** 3
             + it_max * L * 2 * p ** 2 + 8 * L * 2 * p * n)
    out["sqrt_concomitant_10000x500_30lam"] = dict(
        ms=round(ms, 2), iters_max_lane=it_max,
        model_gflop=round(flops / 1e9, 1),
        achieved_tflops=round(flops / (ms * 1e-3) / 1e12, 2),
        pct_of_ceiling=round(100 * flops / (ms * 1e-3) / 1e12 / ceiling, 1))


def glasso_row(out):
    """Attribute the glasso wall to its dominant op (eigh) by measuring
    one eigh of the iteration's shape alone."""
    from admm_tpu.models.glasso import glasso_path

    rng = np.random.default_rng(0)
    n, p, L = 2000, 200, 20
    Z = rng.normal(size=(n, p)).astype(np.float32)
    import time

    res = glasso_path(Z, nlambda=L)
    jax.block_until_ready(res.precision)
    t0 = time.perf_counter()
    res = glasso_path(Z * np.float32(1 + 1e-6), nlambda=L)
    jax.block_until_ready(res.precision)
    ms = (time.perf_counter() - t0) * 1e3
    iters = int(np.asarray(res.niter).sum())

    A = jnp.asarray(rng.normal(size=(p, p)).astype(np.float32))
    A = A + A.T

    def one_eigh(i, A):
        w, V = jnp.linalg.eigh(A * (1.0 + 1e-6 * (i + 1).astype(A.dtype)))
        return jnp.sum(w) + jnp.sum(V)

    eigh_ms = amortized_ms(one_eigh, 20, 100, args=(A,))
    out["glasso_scan_p200_20lam"] = dict(
        ms=round(ms, 1), total_iters=iters,
        eigh_ms_each=round(eigh_ms, 3),
        eigh_pct_of_wall=round(100 * iters * eigh_ms / ms, 1),
        note="eigh-bound (one p x p eigh per iteration); the matmul "
             "roofline does not apply")


def slope_row(out):
    """Attribute the SLOPE scan wall to the sorted-l1 prox by measuring
    one prox call of the iteration's shape alone."""
    from admm_tpu.models.slope import _slope_path_dev, bh_sequence, \
        prox_sorted_l1

    rng = np.random.default_rng(0)
    n, p, L = 10000, 500, 30
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p, np.float32)
    b[:25] = rng.normal(size=25).astype(np.float32) * 2
    y = X @ b + rng.normal(size=n).astype(np.float32)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    seq = jnp.asarray(bh_sequence(p, 0.1), jnp.float32)
    res = _slope_path_dev(Xj, yj, seq, L, 1e-2, None, jnp.float32(-1.0),
                          10000, 1e-5, 1e-5, standardize_x=True,
                          intercept=True, path_mode="scan")
    iters = int(np.asarray(res.niter).sum())

    def one(i, Xj, yj):
        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        r = _slope_path_dev(Xj, yy, seq, L, 1e-2, None,
                            jnp.float32(-1.0), 10000, 1e-5, 1e-5,
                            standardize_x=True, intercept=True,
                            path_mode="scan")
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ms = amortized_ms(one, 2, 8, args=(Xj, yj))
    v = jnp.asarray(rng.normal(size=p), jnp.float32)

    def one_prox(i, v):
        return jnp.sum(prox_sorted_l1(
            v * (1.0 + 1e-6 * (i + 1).astype(v.dtype)), seq))

    prox_ms = amortized_ms(one_prox, 50, 250, args=(v,))
    out["slope_scan_10000x500_30lam"] = dict(
        ms=round(ms, 1), total_iters=iters,
        prox_ms_each=round(prox_ms, 4),
        prox_pct_of_wall=round(100 * iters * prox_ms / ms, 1),
        note="prox-bound at p=500 (dense minimax isotonic per "
             "iteration); the matmul roofline does not apply")


def main():
    out = {}
    ceiling, cms = matmul_ceiling_tflops()
    out["matmul_highest_ceiling_tflops"] = round(ceiling, 1)
    print("ceiling:", out["matmul_highest_ceiling_tflops"], "TF/s",
          flush=True)
    Xj, yj = flagship_row(out, ceiling)
    print(json.dumps(out.get("flagship_scan_10000x1000_100lam")),
          flush=True)
    cv_row(out, ceiling, Xj, yj)
    print(json.dumps(out.get("cv_onepass_10fold_10000x1000_100lam")),
          flush=True)
    sqrt_row(out, ceiling)
    glasso_row(out)
    slope_row(out)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
