"""Full benchmark suite mirroring the reference's published numbers.

Every row of BASELINE.md (the reference README's seeded microbenchmark
section, /root/reference/README.md:190-418) is reproduced here with the
same problem generator (seeded, same shapes) and measured on the current
JAX backend, which every result names.  Results are printed as a table
and written to ``benchmarks/results_<backend>.json``.

Timing protocol: each benchmark runs K full solves inside ONE jitted
``fori_loop`` (inputs perturbed per repetition so nothing is CSE'd),
forces completion with a scalar host read, and differences two K values
— ``(wall(K2) - wall(K1))/(K2 - K1)`` cancels the constant dispatch and
read-back overhead, leaving device time per solve.  The same protocol is
used by bench.py (the headline).

Run:  python benchmarks/run_baselines.py [--fast] [--no-oracle]
  --fast       smaller K (quicker, noisier)
  --no-oracle  skip the sklearn/ground-truth agreement columns
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Problem generators (seeded like the reference README benchmarks)
# ---------------------------------------------------------------------------

def regression_problem(n, p, m, seed=123):
    """Reference README's Lasso generator (README.md:195-204)."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32), b


def lad_problem(n, p, seed=123):
    """Reference README's LAD generator (README.md:296-304):
    b = runif(p), x = rnorm(sd=2), y = x b + rnorm, fit with
    intercept=FALSE."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p)
    X = rng.normal(scale=2.0, size=(n, p))
    y = X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32), b


def bp_problem(n, p, k, seed=123):
    """Reference README's BP generator (README.md:368-377): sparse signal,
    exact measurements."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros(p)
    x0[rng.choice(p, k, replace=False)] = rng.normal(size=k)
    A = rng.normal(size=(n, p)) / np.sqrt(n)
    return A.astype(np.float32), (A @ x0).astype(np.float32), x0


# ---------------------------------------------------------------------------
# Amortized two-point timer
# ---------------------------------------------------------------------------

def amortized_ms(make_scalar, k_small, k_large, repeats=3, args=()):
    """Median on-device ms per solve.  ``make_scalar(i, *args)`` runs one
    full solve (perturbed by repetition index i) and returns a scalar.

    Pass large arrays via ``args`` rather than closing over them:
    closed-over jax Arrays are baked into the HLO as CONSTANTS, which
    bloats the program and its compile time."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run_k(K, *args):
        def body(i, acc):
            return acc + make_scalar(i, *args)
        return lax.fori_loop(0, K, body, jnp.float32(0.0))

    def wall(K):
        t0 = time.perf_counter()
        float(run_k(K, *args))
        return (time.perf_counter() - t0) * 1e3

    wall(k_small)  # compile + warm-up (K is dynamic: one compile total)
    samples = []
    for _ in range(repeats):
        t1 = wall(k_small)
        t2 = wall(k_large)
        samples.append((t2 - t1) / (k_large - k_small))
    return float(np.median(samples))


# ---------------------------------------------------------------------------
# Benchmarks (one function per BASELINE.md row)
# ---------------------------------------------------------------------------

def bench_lasso_path(fast):
    import jax.numpy as jnp
    from admm_tpu.models.lasso import _path_auto

    X, y, _ = regression_problem(10000, 1000, 100)
    X, y = jnp.asarray(X), jnp.asarray(y)

    def one(i, alpha=1.0, enet=False, mode="batch"):
        yy = y * (1.0 + 1e-6 * (i + 1).astype(y.dtype))
        res = _path_auto(X, yy, 100, 1e-4, -1.0, 10000, 1e-5, 1e-5, alpha,
                         standardize_x=True, intercept=True,
                         enet_scale=enet, path_mode=mode)
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    # K must be large enough that (wall(K2)-wall(K1)) clears dispatch
    # jitter or the estimate can even go negative — full mode is
    # authoritative.
    ks = (2, 20) if fast else (4, 36)
    out = {}
    out["lasso_path_10000x1000_ms"] = dict(
        value=amortized_ms(one, *ks), baseline_ms=321.0,
        note="admm 321.0 / glmnet 1043.3 / padmm 512.5 (README.md:206-224)")
    out["lasso_path_10000x1000_scan_ms"] = dict(
        value=amortized_ms(partial(one, mode="scan"), *((1, 4) if fast
                                                        else (2, 12))),
        baseline_ms=321.0,
        note="sequential warm-started protocol (the reference's own)")
    out["enet_path_10000x1000_alpha0.6_ms"] = dict(
        value=amortized_ms(partial(one, alpha=0.6, enet=True), *ks),
        baseline_ms=289.0, note="admm 289.0 / glmnet 1049.9")
    return out


def bench_lasso_wide(fast):
    import jax.numpy as jnp
    from admm_tpu.models.lasso import _path_auto

    X, y, _ = regression_problem(1000, 2000, 100)
    X, y = jnp.asarray(X), jnp.asarray(y)

    def one(i):
        yy = y * (1.0 + 1e-6 * (i + 1).astype(y.dtype))
        res = _path_auto(X, yy, 100, 0.01, -1.0, 10000, 1e-5, 1e-5, 1.0,
                         standardize_x=True, intercept=True,
                         enet_scale=False, path_mode="batch")
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    ks = (1, 4) if fast else (2, 10)
    return {"lasso_path_wide_1000x2000_ms": dict(
        value=amortized_ms(one, *ks), baseline_ms=247.4,
        note="admm 247.4 / glmnet 199.4 / padmm 5345.6 (README.md:257-275)")}


def bench_lad(fast):
    import jax.numpy as jnp
    from admm_tpu.models.lad import _lad_fit

    out = {}
    for (n, p), base, key in [((1000, 500), 51.6, "lad_1000x500_ms"),
                              ((5000, 1000), 2189.0, "lad_5000x1000_ms")]:
        X, y, _ = lad_problem(n, p)
        X, y = jnp.asarray(X), jnp.asarray(y)

        def one(i, X=X, y=y):
            yy = y * (1.0 + 1e-6 * (i + 1).astype(y.dtype))
            # intercept=False as in the reference benchmark
            # (README.md:306 "admm_lad(x, y, intercept = FALSE)").
            # Shipped f32 defaults: eps 2e-5 (the f64-accuracy-matching
            # tolerance) and rho 5.0 (measured sweep; both in DESIGN.md)
            # so this speed row measures the same protocol the oracle
            # accuracy row certifies.
            res = _lad_fit(X, yy, 5.0, 10000, 2e-5, 2e-5, intercept=False)
            return (jnp.sum(res.coef) + res.beta0
                    + res.niter.astype(jnp.float32))

        ks = (1, 4) if fast else (2, 10)
        out[key] = dict(value=amortized_ms(one, *ks), baseline_ms=base,
                        note=f"reference admm {base} ms "
                             "(README.md:306-324, :343-355)")
    return out


def bench_bp(fast):
    import jax.numpy as jnp
    from admm_tpu.models.bp import _bp_fit

    out = {}
    for (n, p, k), base, key in [
            ((1000, 2000, 100), 292.0, "bp_1000x2000_ms"),
            ((1000, 10000, 200), 4969.0, "bp_1000x10000_ms")]:
        A, b, _ = bp_problem(n, p, k)
        A, b = jnp.asarray(A), jnp.asarray(b)

        def one(i, A=A, b=b):
            bb = b * (1.0 + 1e-6 * (i + 1).astype(b.dtype))
            # Shipped f32 defaults eps 2e-5, rho 5.0 (see models/bp.py).
            res = _bp_fit(A, bb, 5.0, 10000, 2e-5, 2e-5)
            return jnp.sum(res.coef) + res.niter.astype(jnp.float32)

        # The two K points must span well over the host-side jitter.
        ks = (2, 10) if fast else (2, 14)
        out[key] = dict(value=amortized_ms(one, *ks), baseline_ms=base,
                        note=f"reference admm {base} ms elapsed "
                             "(README.md:379-393, :405-418)")
    return out


def bench_glm(fast):
    """Informational rows (no reference baseline: the reference is
    gaussian-only): the smooth-loss GLM paths at 2000 x 200, 30
    lambdas, at the SHIPPED defaults — fixed-majorizer x-update +
    batched lambda lanes for the bounded-curvature families, the
    per-lambda adaptive majorizer (curvature-ratio damped) + warm
    scan for poisson, measured auto-rho
    (DESIGN.md "GLM tier, closed"; the full decision sweep lives in
    benchmarks/glm_sweep.py)."""
    import jax.numpy as jnp
    from admm_tpu.models.glm import binomial, huber, poisson
    from admm_tpu.models.glm import _glm_path

    rng = np.random.default_rng(123)
    n, p = 2000, 200
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p); b[:10] = rng.uniform(0.5, 1.5, 10)
    eta = 0.3 + X @ b * 0.3
    ys = {
        "logistic": (rng.uniform(size=n) < 1/(1+np.exp(-eta))).astype(
            np.float32),
        "huber": (eta + 0.3 * rng.normal(size=n)).astype(np.float32),
        "poisson": rng.poisson(np.exp(np.clip(eta * 0.3, None, 3.0))
                               ).astype(np.float32),
    }
    fams = {"logistic": binomial(), "huber": huber(1.345),
            "poisson": poisson()}
    Xj = jnp.asarray(X)
    out = {}
    for name, fam in fams.items():
        yj = jnp.asarray(ys[name])

        # Shipped defaults: poisson (adaptive majorizer, warm scan)
        # runs ONE damped MM step per x-update (measured equivalent
        # to 2; models/glm.py::poisson_lasso_path).
        ns = 1 if fam.curvature_bound is None else 2

        def one(i, Xj=Xj, yj=yj, fam=fam, ns=ns):
            # Perturb X (labels must stay 0/1 and counts integral) so
            # the solve depends on i and cannot be CSE'd out of the
            # timing loop.
            XX = Xj * (1.0 + 1e-7 * (i + 1).astype(Xj.dtype))
            r = _glm_path(XX, yj, 30, 1e-2, None, -1.0, 10000,
                          1e-5, 1e-5, 1.0, family=fam,
                          standardize_x=True, intercept=True,
                          path_mode="auto", newton_steps=ns)
            return jnp.sum(r.coef) + jnp.sum(r.niter)
        # Short solves for the fixed-majorizer families: the K spread
        # must clear the host-side jitter.
        bounded = fam.curvature_bound is not None
        ks = ((2, 8) if fast else (4, 24)) if bounded else \
            ((1, 3) if fast else (1, 5))
        out[f"glm_{name}_path_2000x200_ms"] = dict(
            value=amortized_ms(one, *ks), baseline_ms=None,
            note="30-lambda path at shipped defaults (fixed-majorizer "
                 "batch for binomial/huber, adaptive-majorizer scan for "
                 "poisson); "
                 "extension (reference is gaussian-only)")
    return out


def bench_multi(fast):
    """Informational rows for the matrix-variable families (no
    reference baseline — single-response only there): the multi-task
    Lasso at flagship scale (10000 x 1000, K=8 tasks) and the
    multinomial path (2000 x 200, C=5), both at shipped defaults
    (batched lambda lanes; shared factorized matrices)."""
    import jax.numpy as jnp
    from admm_tpu.models.multinomial import _mn_path
    from admm_tpu.models.multitask import _mt_path

    rng = np.random.default_rng(123)
    out = {}

    n, p, K = 10000, 1000, 8
    B = np.zeros((p, K), np.float32)
    B[rng.choice(p, 100, replace=False)] = rng.uniform(
        -1, 1, (100, K)).astype(np.float32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    Y = (X @ B + rng.normal(size=(n, K))).astype(np.float32)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    def one_mt(i, Xj, Yj):
        YY = Yj * (1.0 + 1e-6 * (i + 1).astype(Yj.dtype))
        r = _mt_path(Xj, YY, 50, 1e-2, None, -1.0, 10000, 1e-5, 1e-5,
                     standardize_x=True, intercept=True,
                     path_mode="batch")
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ks = (1, 4) if fast else (2, 10)
    out["multitask_path_10000x1000_K8_ms"] = dict(
        value=amortized_ms(one_mt, *ks, args=(Xj, Yj)),
        baseline_ms=None,
        note="50-lambda batched path, 8 tasks, shared support; "
             "extension (reference is single-response)")

    n2, p2, C = 2000, 200, 5
    X2 = rng.normal(size=(n2, p2)).astype(np.float32)
    BC = np.zeros((p2, C), np.float32)
    BC[:10] = rng.uniform(-1.5, 1.5, (10, C)).astype(np.float32)
    eta = X2 @ BC
    pr = np.exp(eta - eta.max(axis=1, keepdims=True))
    pr /= pr.sum(axis=1, keepdims=True)
    lab = np.array([rng.choice(C, p=pi) for pi in pr]).astype(np.float32)
    X2j, labj = jnp.asarray(X2), jnp.asarray(lab)

    def one_mn(i, X2j, labj):
        XX = X2j * (1.0 + 1e-7 * (i + 1).astype(X2j.dtype))
        r = _mn_path(XX, labj, 30, 1e-2, None, -1.0, 10000, 1e-5, 1e-5,
                     1.0, nclass=C, standardize_x=True, intercept=True,
                     path_mode="batch", grouped=False, newton_steps=2)
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ks = (2, 8) if fast else (4, 24)
    out["multinomial_path_2000x200_C5_ms"] = dict(
        value=amortized_ms(one_mn, *ks, args=(X2j, labj)),
        baseline_ms=None,
        note="30-lambda batched softmax path, 5 classes, fixed "
             "majorizer; extension (reference is gaussian-only)")

    # Cox proportional hazards at the same shape (50% censoring).
    from admm_tpu.models.cox import _cox_path, _tie_groups

    tc = rng.exponential(np.exp(-(X2 @ BC[:, 0] * 0.5)))
    dc = (rng.uniform(size=n2) < 0.5).astype(np.float32)
    order = np.argsort(-tc, kind="stable")
    first, last = _tie_groups(tc[order])
    Xc = jnp.asarray(X2[order])
    djc = jnp.asarray(dc[order])

    def one_cox(i, Xc, djc):
        XX = Xc * (1.0 + 1e-7 * (i + 1).astype(Xc.dtype))
        # Shipped default: warm-started scan with the per-lambda
        # adaptive majorizer (models/cox.py — 34x fewer iterations
        # than cold batch lanes under the global d/2 bound).
        r = _cox_path(XX, djc, first, last, 30, 1e-2, None, -1.0,
                      10000, 1e-5, 1e-5, 1.0, standardize_x=True,
                      path_mode="scan", newton_steps=2)
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    ks = (1, 3) if fast else (1, 5)
    out["cox_path_2000x200_ms"] = dict(
        value=amortized_ms(one_cox, *ks, args=(Xc, djc)),
        baseline_ms=None,
        note="30-lambda Breslow partial-likelihood path (warm-started "
             "adaptive-majorizer scan), 50% censoring; extension "
             "(reference is gaussian-only)")
    return out


def bench_scale(fast):
    """Scale headroom: the flagship path at 10x the reference's rows
    (100k x 1000, 100 lambdas, device-resident data — the serving
    shape: load once, solve repeatedly)."""
    import jax
    import jax.numpy as jnp
    from admm_tpu.models.lasso import _path_auto

    if fast:
        return {}
    n, p = 100_000, 1000
    rng = np.random.default_rng(123)
    b = np.zeros(p, np.float32)
    b[rng.choice(p, 100, replace=False)] = rng.uniform(
        -1, 1, 100).astype(np.float32)
    X = rng.normal(size=(n, p)).astype(np.float32)
    y = (5.0 + X @ b + rng.normal(size=n)).astype(np.float32)
    Xj = jax.device_put(jnp.asarray(X))
    yj = jax.device_put(jnp.asarray(y))
    del X

    def one(i, Xj, yj):
        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        r = _path_auto(Xj, yy, 100, 1e-4, -1.0, 10000, 1e-5, 1e-5, 1.0,
                       standardize_x=True, intercept=True,
                       enet_scale=False, path_mode="batch")
        return jnp.sum(r.coef) + jnp.sum(r.niter)

    return {"lasso_path_100000x1000_ms": dict(
        value=amortized_ms(one, 2, 10, args=(Xj, yj)), baseline_ms=None,
        note="100-lambda batched path at 10x the reference's flagship "
             "rows, device-resident (one-time 400 MB load excluded; "
             "the on-device solve is what repeats in serving)")}


def bench_cv(fast):
    """One-program CV vs the host fold loop on the flagship problem
    (10-fold, 100 lambdas).  Unlike the other rows this one measures
    WALL time (median after warm-up): the dispatch round-trips are
    exactly what the one-pass design removes, so amortizing them away
    would hide the effect being measured (models/cv.py module
    docstring)."""
    import jax
    import jax.numpy as jnp
    from admm_tpu.models.cv import cv_lasso_path

    n, p = (10000, 1000) if not fast else (4000, 400)
    X, y, _ = regression_problem(n, p, 100)
    # Device-resident design matrix: cv_lasso_path keeps it on device
    # end-to-end for the one-pass sweep, so repeated CVs pay ZERO
    # host->device re-uploads of the 40 MB matrix.  The loop mode
    # must subset rows on host, so it pulls the matrix back and pays
    # the transfers — that asymmetry is the point being measured.
    Xd = jax.device_put(jnp.asarray(X, jnp.float32))
    out = {}
    reps = 3 if fast else 5
    vals = {}
    for mode in ("onepass", "loop"):
        cv_lasso_path(Xd, y, nfolds=10, nlambda=100, cv_mode=mode,
                      seed=1)  # warm-up/compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cv_lasso_path(Xd, y, nfolds=10, nlambda=100, cv_mode=mode,
                          seed=1)
            ts.append((time.perf_counter() - t0) * 1e3)
        vals[mode] = float(np.median(ts))
    out[f"cv_lasso_path_{n}x{p}_onepass_ms"] = dict(
        value=round(vals["onepass"], 1), baseline_ms=None,
        note=f"10-fold 100-lambda CV wall ms; host fold loop takes "
             f"{vals['loop']:.1f} ms ({vals['loop']/vals['onepass']:.1f}"
             "x) — the one-pass fold sweep is 2 dispatches instead of "
             "11 (models/cv.py)")

    # Cox CV: the round-3 one-pass extension (weight-zero Breslow
    # lanes).  The loop mode refits per fold AND re-sorts/re-uploads
    # per fold — same wall-time protocol as above.
    from admm_tpu.models.cox import cv_cox_path

    nc, pc = (2000, 200) if not fast else (800, 80)
    rng = np.random.default_rng(123)
    Xc = rng.normal(size=(nc, pc))
    bc = np.zeros(pc)
    bc[:10] = rng.uniform(0.5, 1.5, 10) * rng.choice([-1, 1], 10)
    tc = rng.exponential(np.exp(-(Xc @ bc)))
    dc = (rng.uniform(size=nc) < 0.7).astype(float)
    nl = 10 if fast else 20
    cvals = {}
    for mode in ("onepass", "loop"):
        cv_cox_path(Xc, tc, dc, nfolds=5, nlambda=nl, cv_mode=mode,
                    seed=1)  # warm-up/compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            cv_cox_path(Xc, tc, dc, nfolds=5, nlambda=nl, cv_mode=mode,
                        seed=1)
            ts.append((time.perf_counter() - t0) * 1e3)
        cvals[mode] = float(np.median(ts))
    out[f"cv_cox_path_{nc}x{pc}_onepass_ms"] = dict(
        value=round(cvals["onepass"], 1), baseline_ms=None,
        note=f"5-fold {nl}-lambda cox CV wall ms; host fold loop takes "
             f"{cvals['loop']:.1f} ms "
             f"({cvals['loop']/cvals['onepass']:.1f}x) — fold lanes as "
             "weight-zero Breslow risk sets (models/cox.py)")
    return out


def bench_round4(fast):
    """Round-4 extension rows: graphical lasso, linear SVM, robust PCA
    (no reference analog — the reference is a regression package)."""
    import jax.numpy as jnp
    from admm_tpu.models.glasso import _glasso_path_dev, empirical_covariance
    from admm_tpu.models.rpca import _rpca_dev
    from admm_tpu.models.svm import _svm_path_dev

    out = {}
    rng = np.random.default_rng(123)

    # Graphical lasso: p=200 precision path, 20 lambdas.
    A = rng.normal(size=(2000, 200)).astype(np.float32)
    S = empirical_covariance(jnp.asarray(A))

    def one_gl(i, S, mode="batch"):
        Sp = S * (1.0 + 1e-6 * (i + 1).astype(S.dtype))
        res = _glasso_path_dev(Sp, 20, 1e-2, None, jnp.float32(-1.0),
                               10000, 1e-5, 1e-5,
                               penalize_diagonal=False, path_mode=mode)
        return jnp.sum(res.precision) + jnp.sum(res.niter)

    ks = (1, 5) if fast else (2, 10)
    out["glasso_path_p200_20lambdas_ms"] = dict(
        value=amortized_ms(partial(one_gl, mode="scan"), *ks, args=(S,)),
        baseline_ms=None,
        note="20-lambda sparse-precision path, p=200, warm-started scan "
             "with the Newton-Schulz logdet prox (the measured defaults "
             "— DESIGN.md; 28x over the r4 eigh prox); extension "
             "(reference is regression-only)")
    out["glasso_path_p200_20lambdas_batch_ms"] = dict(
        value=amortized_ms(one_gl, *ks, args=(S,)), baseline_ms=None,
        note="batched lanes for the same path (loses ~2x: iterations "
             "don't amortize across lanes, and batch runs to the "
             "slowest cold lane)")

    # Linear SVM: n=2000, p=100, 20-C path (shared factorization).
    Xs = rng.normal(size=(2000, 100)).astype(np.float32)
    ys = np.sign(Xs @ rng.normal(size=100) + 0.3 * rng.normal(size=2000))
    Xj = jnp.asarray(Xs)
    ysj = jnp.asarray(ys, jnp.float32)
    Cs = jnp.asarray(np.geomspace(1.0, 1e-3, 20), jnp.float32)
    ow = jnp.ones((2000,), jnp.float32)

    def one_svm(i, Xj, ysj):
        Xp = Xj * (1.0 + 1e-6 * (i + 1).astype(Xj.dtype))
        res = _svm_path_dev(Xp, ysj, Cs, ow, jnp.float32(-1.0), 20000,
                            1e-5, 1e-5, loss="squared_hinge",
                            intercept=True, path_mode="batch")
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    out["svm_path_2000x100_20C_ms"] = dict(
        value=amortized_ms(one_svm, *ks, args=(Xj, ysj)),
        baseline_ms=None,
        note="20-C squared-hinge path as batched lanes against one cached "
             "factorization; extension")

    # SLOPE: 10000x500 30-scale path (the sorted-l1 prox is the per-
    # iteration cost: argsort + two (p, p) cumulative reductions).
    Xsl = rng.normal(size=(10000, 500)).astype(np.float32)
    bsl = np.zeros(500, np.float32)
    bsl[:10] = rng.normal(size=10)
    ysl = (Xsl @ bsl + rng.normal(size=10000)).astype(np.float32)
    Xslj, yslj = jnp.asarray(Xsl), jnp.asarray(ysl)

    def one_slope(i, Xj, yj):
        from admm_tpu.models.slope import _slope_path_dev, bh_sequence

        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        res = _slope_path_dev(
            Xj, yy, jnp.asarray(bh_sequence(500, 0.1), jnp.float32),
            30, 1e-2, None, jnp.float32(-1.0), 10000, 1e-5, 1e-5,
            standardize_x=True, intercept=True, path_mode="scan")
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    out["slope_path_10000x500_30lambdas_ms"] = dict(
        value=amortized_ms(one_slope, *ks, args=(Xslj, yslj)),
        baseline_ms=None,
        note="30-scale sorted-l1 (BH q=0.1) path, warm-started scan "
             "(the auto default at p >= 100 — the O(p^2) prox doesn't "
             "amortize across lanes, DESIGN.md); extension")

    # Square-root lasso: same 10000x500 design, 30 lambdas.
    def one_sqrt(i, Xj, yj):
        from admm_tpu.models.sqrtlasso import _sqrt_path_dev

        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        res = _sqrt_path_dev(Xj, yy, 30, 1e-2, None, jnp.float32(-1.0),
                             10000, 1e-6, 1e-6, standardize_x=True,
                             intercept=True, path_mode="batch")
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    out["sqrt_lasso_path_10000x500_30lambdas_ms"] = dict(
        value=amortized_ms(one_sqrt, *ks, args=(Xslj, yslj)),
        baseline_ms=None,
        note="30-lambda pivotal (square-root) lasso path, concomitant "
             "(scaled-lasso) alternation on the cached tall engine as "
             "batched lanes (159x over the r4 stacked splitting, "
             "DESIGN.md 'sqrt-lasso algorithm race'); extension")

    # Constrained (zero-sum) lasso: 10000x500, 30 lambdas.
    def one_con(i, Xj, yj):
        from admm_tpu.models.conlasso import _conlasso_path_dev

        yy = yj * (1.0 + 1e-6 * (i + 1).astype(yj.dtype))
        C = jnp.ones((1, 500), jnp.float32)
        d = jnp.zeros((1,), jnp.float32)
        res = _conlasso_path_dev(Xj, yy, C, d, 30, 1e-3, None,
                                 jnp.float32(-1.0), 10000, 1e-5, 1e-5,
                                 intercept=True, path_mode="batch")
        return jnp.sum(res.coef) + jnp.sum(res.niter)

    out["zerosum_lasso_path_10000x500_30lambdas_ms"] = dict(
        value=amortized_ms(one_con, *ks, args=(Xslj, yslj)),
        baseline_ms=None,
        note="30-lambda equality-constrained (zero-sum) path, "
             "KKT-eliminated x-update; extension")

    # Robust PCA: 500x500 low-rank + sparse separation.
    L0 = (rng.normal(size=(500, 5)) @ rng.normal(size=(5, 500))
          ).astype(np.float32)
    Sp0 = np.zeros((500, 500), np.float32)
    m = rng.uniform(size=Sp0.shape) < 0.05
    Sp0[m] = 10 * rng.choice([-1.0, 1.0], size=m.sum())
    M = jnp.asarray(L0 + Sp0)

    def one_rpca(i, M):
        Mp = M * (1.0 + 1e-6 * (i + 1).astype(M.dtype))
        res = _rpca_dev(Mp, jnp.float32(1.0 / np.sqrt(500)),
                        jnp.float32(-1.0), 2000, 1e-6, 1e-5)
        return jnp.sum(res.low_rank) + res.niter.astype(jnp.float32)

    out["rpca_500x500_ms"] = dict(
        value=amortized_ms(one_rpca, *((1, 4) if fast else (2, 8)),
                           args=(M,)),
        baseline_ms=None,
        note="exact low-rank + sparse separation (SVD per iteration); "
             "extension")

    # Robust PCA at 2000x2000 via the warm-started partial SVT
    # (rank-adaptive subspace iteration, DESIGN.md "RPCA partial SVT" —
    # the exact-SVD solve is 3.4 s at this size).
    L2 = (rng.normal(size=(2000, 5)) @ rng.normal(size=(5, 2000))
          / np.sqrt(5)).astype(np.float32)
    Sp2 = np.zeros((2000, 2000), np.float32)
    m2 = rng.uniform(size=Sp2.shape) < 0.05
    Sp2[m2] = 10 * rng.choice([-1.0, 1.0], size=m2.sum())
    M2 = jnp.asarray(L2 + Sp2)

    def one_rpca2k(i, M2):
        Mp = M2 * (1.0 + 1e-6 * (i + 1).astype(M2.dtype))
        res = _rpca_dev(Mp, jnp.float32(1.0 / np.sqrt(2000)),
                        jnp.float32(-1.0), 2000, 1e-6, 1e-5,
                        rank=5)
        return jnp.sum(res.low_rank) + res.niter.astype(jnp.float32)

    out["rpca_2000x2000_partial_ms"] = dict(
        value=amortized_ms(one_rpca2k, *((1, 3) if fast else (2, 6)),
                           args=(M2,)),
        baseline_ms=None,
        note="2000x2000 PCP via warm-started partial SVT (rank=5; 73x "
             "over the exact SVD at this size, DESIGN.md); extension")
    return out


def bench_consensus_scaling(fast):
    """On-chip batched-worker scaling (the measurable half of the
    BASELINE north star): W = 1..16 consensus workers on ONE chip, all
    vectorized as the leading einsum axis — the accelerator analog of
    the reference's OpenMP threads (reference: src/PADMMBase.h:180-188).
    Fixed problem (8192 x 256, 3 lambdas, eps 1e-6): total row count is
    constant, so flat time-vs-W means on-chip workers are free (the
    matmul absorbs the worker axis) and the consensus penalty is iterations,
    which are reported alongside."""
    import jax.numpy as jnp
    from admm_tpu.parallel.consensus import _consensus_lasso_shard

    n, p = 8192, 256
    X, y, _ = regression_problem(n, p, 32, seed=7)
    X, y = jnp.asarray(X), jnp.asarray(y)
    lam0 = float(jnp.max(jnp.abs(X.T @ y)))
    ilams = jnp.asarray([0.3 * lam0, 0.1 * lam0, 0.03 * lam0],
                        jnp.float32)

    out = {}
    scaling = {}
    for W in (1, 2, 4, 8, 16):
        Xb = X.reshape(W, n // W, p)
        yb = y.reshape(W, n // W)
        x0 = jnp.zeros((W, p), jnp.float32)
        z0 = jnp.zeros((p,), jnp.float32)
        solver = partial(_consensus_lasso_shard, axis=None, nworkers=W,
                         tall_block=True)

        def one(i, Xb=Xb, yb=yb, solver=solver, x0=x0, z0=z0):
            yy = yb * (1.0 + 1e-6 * (i + 1).astype(yb.dtype))
            coefs, niter, _ = solver(Xb, yy, x0, x0, z0, ilams,
                                     jnp.float32(-1.0), 10000,
                                     jnp.float32(1e-6),
                                     jnp.float32(1e-6))
            return jnp.sum(coefs) + jnp.sum(niter).astype(jnp.float32)

        import jax
        _, niter, _ = jax.jit(lambda: solver(
            Xb, yb, x0, x0, z0, ilams, jnp.float32(-1.0), 10000,
            jnp.float32(1e-6), jnp.float32(1e-6)))()
        # Short solves: the two K points must span well over the
        # host-side jitter.
        ks = (2, 12) if fast else (5, 55)
        scaling[f"W{W}"] = dict(
            ms=amortized_ms(one, *ks),
            total_niter=int(np.sum(np.asarray(niter))))
    out["consensus_scaling_onchip"] = dict(
        value=scaling, baseline_ms=None,
        note="fixed 8192x256 problem, 3 lambdas, W batched workers on "
             "one chip (reference analog: OpenMP threads, "
             "src/PADMMBase.h:180-188)")
    return out


# ---------------------------------------------------------------------------
# Oracle agreement (the reference README's correctness columns)
# ---------------------------------------------------------------------------

def oracle_agreement():
    from sklearn.linear_model import Lasso, QuantileRegressor
    from admm_tpu.models.lasso import lasso_path
    from admm_tpu.models.lad import lad_fit
    from admm_tpu.models.bp import bp_fit

    out = {}

    # Lasso path gap vs coordinate descent on the flagship problem (the
    # reference reports [-2.87e-4, 7.26e-5] vs glmnet, README.md:227-242).
    # standardize=False on BOTH sides: sklearn's Lasso penalizes raw-scale
    # coefficients (it has no standardize option), so comparing a
    # glmnet-standardized fit against it measures the convention
    # difference (~1e-2 at high lambda), not solver accuracy.
    X, y, _ = regression_problem(10000, 1000, 100)
    res = lasso_path(X, y, nlambda=100, path_mode="batch",
                     standardize=False)
    lams = np.asarray(res.lambdas)
    idx = [10, 40, 70, 99]
    gaps = []
    for i in idx:
        # tol 2e-7 gives a CD solution accurate well past the ~1e-4
        # agreement being measured; tighter tolerances cost minutes per
        # path point on this problem size.
        sk = Lasso(alpha=float(lams[i]), fit_intercept=True,
                   tol=2e-7, max_iter=20000).fit(X, y)
        gaps.append(np.abs(np.asarray(res.coef[i]) - sk.coef_).max())
    out["lasso_coef_gap_vs_sklearn"] = dict(
        value=float(np.max(gaps)), baseline=2.9e-4,
        note="max|beta_admm - beta_cd| over 4 path points; reference "
             "reports ~2.9e-4 vs glmnet")

    # LAD gap vs quantile regression on the reference's own benchmark
    # config (no intercept; reference: +-7e-3 vs quantreg[br],
    # README.md:327-333).
    X, y, _ = lad_problem(1000, 500)
    r = lad_fit(X, y, intercept=False)
    qr = QuantileRegressor(quantile=0.5, alpha=0.0, fit_intercept=False,
                           solver="highs").fit(X, y)
    out["lad_coef_gap_vs_quantreg"] = dict(
        value=float(np.abs(np.asarray(r.coef) - qr.coef_).max()),
        baseline=7e-3, note="n=1000, p=500, intercept=False")

    # BP recovery error (reference: [-1.27e-3, 2.11e-3]).
    A, b, x0 = bp_problem(1000, 2000, 100)
    r = bp_fit(A, b)
    out["bp_recovery_err"] = dict(
        value=float(np.abs(np.asarray(r.coef) - x0).max()),
        baseline=2.11e-3, note="max|x - x0|, n=1000 p=2000 k=100")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--no-oracle", action="store_true")
    args = ap.parse_args()

    from admm_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    backend = jax.default_backend()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device={device}", file=sys.stderr)

    results = {}
    for name, fn in [("lasso", bench_lasso_path),
                     ("lasso_wide", bench_lasso_wide),
                     ("lad", bench_lad), ("bp", bench_bp),
                     ("glm", bench_glm), ("multi", bench_multi),
                     ("scale", bench_scale), ("cv", bench_cv),
                     ("round4", bench_round4),
                     ("consensus_scaling", bench_consensus_scaling)]:
        t0 = time.time()
        results.update(fn(args.fast))
        print(f"# {name} done in {time.time()-t0:.1f}s", file=sys.stderr)
    if not args.no_oracle:
        results.update(oracle_agreement())

    width = max(len(k) for k in results)
    for k, v in results.items():
        if isinstance(v["value"], dict):   # nested section (scaling)
            print(f"{k}:")
            for kk, vv in v["value"].items():
                print(f"  {kk:<6} {vv['ms']:10.3f} ms  "
                      f"(total niter {vv['total_niter']})")
            continue
        base = v.get("baseline_ms", v.get("baseline"))
        speed = (f"  {base / v['value']:8.1f}x vs ref"
                 if "baseline_ms" in v and base else
                 f"  (ref ~{base:g})" if base else "")
        print(f"{k:<{width}}  {v['value']:12.4g}{speed}")

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            f"results_{backend}.json")
    with open(out_path, "w") as f:
        json.dump({"backend": backend, "device": device,
                   "results": results}, f, indent=2)
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
