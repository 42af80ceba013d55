"""Smoke test of the solver paths on the GPU, through the public API.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --chips 4   # four cards: the mesh phases only

One card runs the reference README's problems at their published shapes
(seed 123) and holds every result to an independent float64 numpy/scipy
reference:

  1. device      refuse anything but a GPU backend; print the card
  2. lasso       ``admm_lasso(X, y).fit()`` (batch lanes) and
                 ``lasso_path(X, y)`` (warm-started scan), 10000 x 1000,
                 100 lambdas: f64 KKT at every lambda, batch/scan gap,
                 wall and compile time of the flagship call
  3. enet        ``admm_enet(...).penalty(alpha=0.6).fit()``, same data
  4. wide        ``admm_lasso(X, y).fit()`` at 1000 x 2000
  5. lad         ``admm_lad(X, y, intercept=False).fit()``, 1000 x 500,
                 against ``scipy.optimize.linprog``
  6. bp          ``bp_fit_batch(A, B)``, 1000 x 2000, 100 signals, against
                 the known signals and, for the reference's own signal,
                 ``linprog`` (about a minute of host time at this size)
  7. logistic    ``logistic_lasso_path``, 2000 x 200, 30 lambdas, f64 KKT

``--chips 4`` runs the consensus lasso path and the ``data_mesh``
row-sharded ``lasso_path`` at 10000 x 1000 over a 1-D mesh of four
cards, against the one-card serial path and the f64 KKT reference.

Every solver call runs in float32 (the GPU's working precision here);
the references run in float64.  A failed check raises, so the exit code
is non-zero; the last line of a passing run is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances, each stated against its f64 reference.
# Relative KKT violation, max over coefficients and lambdas, of the
# returned coefficients.  Solves stop at the Boyd test with eps 1e-5 in
# float32, so the violation relative to lambda grows toward the small end
# of the grid (lambda_min = 1e-4 lambda_max for the tall paths); on an
# H100 the flagship batch path leaves 1.9e-2 and the enet 3.0e-2.  A
# wrong solution leaves violations of order one.
KKT_TOL = 5e-2
# Two paths leave more, so they get twice the bound: the logistic path's
# inexact-Newton x-update (4.1e-2 on an H100 at 2000 x 200, 30 lambdas
# down to 1e-2 lambda_max) and the consensus path, whose primal test
# certifies the iterate one step late (4.8e-2 over four H100s).
LOOSE_KKT_TOL = 1e-1
# Max |batch - scan| coefficient gap (original scale, coefficients O(1)):
# two f32 solves, each stopped at eps 1e-5, from different starts.
PATH_GAP_TOL = 2e-3
# LAD: the reference's own published gap to quantreg (BASELINE.md), and
# the L1 objective within 1e-3 relative of the LP optimum (the f64
# default eps 1e-4 leaves 1.7e-4 at 300 x 30 on the CPU).
LAD_GAP_TOL = 7e-3
LAD_OBJ_RTOL = 1e-3
# BP: the reference's own published recovery error (BASELINE.md).
BP_ERR_TOL = 2.11e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------

def check_device(devices, count: int = 1) -> None:
    """Refuse to run anywhere but on ``count`` GPUs."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devices)}")


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class CompileTimer:
    """Sums JAX's backend-compile durations while it is active."""

    def __init__(self):
        import jax.monitoring

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


# ---------------------------------------------------------------------------
# Problems (the reference README's seeded generators)
# ---------------------------------------------------------------------------

def regression_problem(n, p, m, seed=123):
    """Reference README's Lasso generator: m nonzeros, intercept 5."""
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def lad_problem(n, p, seed=123):
    """Reference README's LAD generator (fit with intercept=False)."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p)
    X = rng.normal(scale=2.0, size=(n, p))
    y = X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def bp_problem(n, p, k, nsignals, seed=123):
    """Reference README's BP generator: exact measurements of k-sparse
    signals; returns (A, B (nsignals, n), X0 (nsignals, p))."""
    rng = np.random.default_rng(seed)
    X0 = np.zeros((nsignals, p))
    for i in range(nsignals):
        X0[i, rng.choice(p, k, replace=False)] = rng.normal(size=k)
        if i == 0:  # the reference's own signal, then its matrix
            A = (rng.normal(size=(n, p)) / np.sqrt(n)).astype(np.float32)
    B = (X0 @ A.astype(np.float64).T).astype(np.float32)
    return A, B, X0


def logistic_problem(n, p, seed=123):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    b = np.zeros(p)
    b[:10] = rng.uniform(0.5, 1.5, 10)
    eta = 0.3 + 0.3 * (X @ b)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-eta)))
    return X, y.astype(np.float32)


# ---------------------------------------------------------------------------
# Float64 references
# ---------------------------------------------------------------------------

def _standardize64(X, y=None):
    X = np.asarray(X, np.float64)
    mx = X.mean(axis=0)
    sx = X.std(axis=0)
    Xs = (X - mx) / sx
    if y is None:
        return Xs, sx
    y = np.asarray(y, np.float64)
    sy = y.std()
    return Xs, sx, (y - y.mean()) / sy, sy


def _kkt_violation(grad, bs, lam, alpha):
    """Max relative KKT violation of ``bs`` for the standardized problem
    whose smooth-part gradient is ``-grad`` and whose penalty is
    ``lam (alpha |b|_1 + (1 - alpha)/2 |b|^2)``; one row per lambda."""
    g = grad - (lam * (1.0 - alpha))[:, None] * bs
    t = (lam * alpha)[:, None]
    viol = np.where(bs != 0, np.abs(g - t * np.sign(bs)),
                    np.maximum(np.abs(g) - t, 0.0))
    return float((viol / t).max())


def gaussian_kkt(X, y, lambdas, coef, alpha=1.0):
    """glmnet gaussian objective on standardized data (1/n moments):
    ``1/(2n)|ys - Xs b|^2 + lam/sd_y * penalty(b)`` with
    ``b = coef * sd_x / sd_y``."""
    Xs, sx, ys, sy = _standardize64(X, y)
    n = Xs.shape[0]
    bs = np.asarray(coef, np.float64) * sx[None, :] / sy
    grad = (ys[:, None] - Xs @ bs.T).T @ Xs / n
    return _kkt_violation(grad, bs, np.asarray(lambdas, np.float64) / sy,
                          alpha)


def logistic_kkt(X, y, lambdas, beta0, coef):
    """glmnet binomial objective on standardized X: the slopes satisfy
    the lasso KKT conditions of ``1/n sum logloss``; the free intercept
    zeroes the mean residual (checked against the same tolerance)."""
    Xs, sx = _standardize64(X)
    n = Xs.shape[0]
    X64 = np.asarray(X, np.float64)
    coef = np.asarray(coef, np.float64)
    eta = np.asarray(beta0, np.float64)[:, None] + coef @ X64.T
    r = np.asarray(y, np.float64)[None, :] - 1.0 / (1.0 + np.exp(-eta))
    bs = coef * sx[None, :]
    lam = np.asarray(lambdas, np.float64)
    viol = _kkt_violation(r @ Xs / n, bs, lam, 1.0)
    return max(viol, float((np.abs(r.mean(axis=1)) / lam).max()))


def lad_lp(X, y):
    """min |y - X b|_1 as an LP: X b + u - v = y, u, v >= 0."""
    from scipy.optimize import linprog

    X = np.asarray(X, np.float64)
    n, p = X.shape
    c = np.concatenate([np.zeros(p), np.ones(2 * n)])
    A_eq = np.hstack([X, np.eye(n), -np.eye(n)])
    bounds = [(None, None)] * p + [(0, None)] * (2 * n)
    res = linprog(c, A_eq=A_eq, b_eq=np.asarray(y, np.float64),
                  bounds=bounds, method="highs")
    if res.status != 0:
        raise AssertionError(f"LAD linprog failed: {res.message}")
    return res.x[:p]


def bp_lp(A, b):
    """min |x|_1 s.t. A x = b as an LP over x = u - v, u, v >= 0."""
    from scipy.optimize import linprog

    A = np.asarray(A, np.float64)
    p = A.shape[1]
    res = linprog(np.ones(2 * p), A_eq=np.hstack([A, -A]),
                  b_eq=np.asarray(b, np.float64), bounds=(0, None),
                  method="highs")
    if res.status != 0:
        raise AssertionError(f"BP linprog failed: {res.message}")
    return res.x[:p] - res.x[p:]


def _check(name, value, tol):
    ok = value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:.1e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.1e}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_lasso(X, y, compile_timer=None):
    """Flagship path: batch (builder default) and scan (lasso_path
    default) on the same data; f64 KKT at every lambda."""
    import admm_tpu

    c0 = compile_timer.seconds if compile_timer else 0.0
    t0 = time.perf_counter()
    fit = admm_tpu.admm_lasso(X, y).fit()
    first_s = time.perf_counter() - t0
    compile_s = (compile_timer.seconds - c0) if compile_timer else 0.0
    t0 = time.perf_counter()
    fit = admm_tpu.admm_lasso(X, y).fit()
    warm_s = time.perf_counter() - t0
    beta = fit.beta.toarray()
    coef_b = beta[1:].T
    log(f"  admm_lasso().fit() batch: first call {first_s:.3f} s "
        f"(compile {compile_s:.3f} s), warm call {warm_s:.3f} s, "
        f"host arrays in to results on host; "
        f"iterations total {int(fit.niter.sum())} max "
        f"{int(fit.niter.max())}")

    t0 = time.perf_counter()
    res = admm_tpu.lasso_path(X, y)
    coef_s = np.asarray(res.coef)
    scan_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = admm_tpu.lasso_path(X, y)
    coef_s = np.asarray(res.coef)
    scan_warm_s = time.perf_counter() - t0
    log(f"  lasso_path() scan: first call {scan_first_s:.3f} s, warm "
        f"call {scan_warm_s:.3f} s; iterations total "
        f"{int(np.asarray(res.niter).sum())}")

    lam_gap = float(np.abs(np.asarray(res.lambdas) / fit.lambda_ - 1).max())
    _check("batch/scan lambda grid relative gap", lam_gap, 1e-5)
    _check("batch KKT", gaussian_kkt(X, y, fit.lambda_, coef_b), KKT_TOL)
    _check("scan KKT", gaussian_kkt(X, y, res.lambdas, coef_s), KKT_TOL)
    _check("batch/scan coefficient gap", float(np.abs(coef_b - coef_s).max()),
           PATH_GAP_TOL)
    return dict(batch_first_s=first_s, batch_compile_s=compile_s,
                batch_warm_s=warm_s, scan_first_s=scan_first_s,
                scan_warm_s=scan_warm_s)


def phase_enet(X, y, alpha=0.6):
    import admm_tpu

    fit = admm_tpu.admm_enet(X, y).penalty(alpha=alpha).fit()
    coef = fit.beta.toarray()[1:].T
    _check(f"enet alpha={alpha} KKT",
           gaussian_kkt(X, y, fit.lambda_, coef, alpha), KKT_TOL)


def phase_wide(X, y):
    import admm_tpu

    fit = admm_tpu.admm_lasso(X, y).fit()
    coef = fit.beta.toarray()[1:].T
    _check("wide KKT", gaussian_kkt(X, y, fit.lambda_, coef), KKT_TOL)


def phase_lad(X, y):
    import admm_tpu

    fit = admm_tpu.admm_lad(X, y, intercept=False).fit()
    coef = np.asarray(fit.beta, np.float64).ravel()[1:]
    ref = lad_lp(X, y)
    X64, y64 = np.asarray(X, np.float64), np.asarray(y, np.float64)
    obj = np.abs(y64 - X64 @ coef).sum()
    obj_ref = np.abs(y64 - X64 @ ref).sum()
    _check("LAD coefficient gap to linprog", float(np.abs(coef - ref).max()),
           LAD_GAP_TOL)
    _check("LAD objective excess over linprog",
           float(max(obj / obj_ref - 1.0, 0.0)), LAD_OBJ_RTOL)


def phase_bp(A, B, X0, n_lp=1):
    import admm_tpu

    res = admm_tpu.bp_fit_batch(A, B)
    coef = np.asarray(res.coef, np.float64)
    _check("BP recovery error, all signals", float(np.abs(coef - X0).max()),
           BP_ERR_TOL)
    for i in range(n_lp):
        ref = bp_lp(A, B[i])
        _check(f"BP gap to linprog, signal {i}",
               float(np.abs(coef[i] - ref).max()), BP_ERR_TOL)


def phase_logistic(X, y, nlambda=30):
    import admm_tpu

    res = admm_tpu.logistic_lasso_path(X, y, nlambda=nlambda)
    _check("logistic KKT",
           logistic_kkt(X, y, np.asarray(res.lambdas), np.asarray(res.beta0),
                        np.asarray(res.coef)), LOOSE_KKT_TOL)


def phase_mesh(X, y, mesh):
    """Consensus path and data_mesh row-sharded path over ``mesh``,
    against the serial one-device path and the f64 KKT reference."""
    import jax
    import admm_tpu
    from admm_tpu.parallel.mesh import put_dim_sharded

    devs = list(mesh.devices.flat)
    if len({d.id for d in devs}) != len(devs):
        raise AssertionError(f"mesh repeats a device: {devs}")
    Xd = put_dim_sharded(jax.numpy.asarray(X), mesh, 0)
    shard_devs = {s.device.id for s in Xd.addressable_shards}
    rows = {s.data.shape[0] for s in Xd.addressable_shards}
    log(f"  row shards on devices {sorted(shard_devs)}, rows per shard "
        f"{sorted(rows)}")
    if shard_devs != {d.id for d in devs} or rows != {X.shape[0] // len(devs)}:
        raise AssertionError("row shards are not one per mesh device")

    ser = admm_tpu.lasso_path(X, y)
    coef_ser = np.asarray(ser.coef)
    par = admm_tpu.parallel_lasso_path(X, y, mesh=mesh)
    coef_par = np.asarray(par.coef)
    shd = admm_tpu.lasso_path(X, y, data_mesh=mesh)
    coef_shd = np.asarray(shd.coef)
    _check("serial KKT", gaussian_kkt(X, y, ser.lambdas, coef_ser), KKT_TOL)
    _check("consensus KKT", gaussian_kkt(X, y, par.lambdas, coef_par),
           LOOSE_KKT_TOL)
    _check("data_mesh KKT", gaussian_kkt(X, y, shd.lambdas, coef_shd),
           KKT_TOL)
    _check("consensus/serial coefficient gap",
           float(np.abs(coef_par - coef_ser).max()), PATH_GAP_TOL)
    _check("data_mesh/serial coefficient gap",
           float(np.abs(coef_shd - coef_ser).max()), PATH_GAP_TOL)
    # The consensus program places its row blocks itself; every card's
    # peak allocation must cover a block.  (The CPU backend keeps no
    # memory statistics.)
    stats = [d.memory_stats() for d in devs]
    if all(stats):
        peak = [st["peak_bytes_in_use"] for st in stats]
        log(f"  peak bytes in use per device: {peak}")
        if min(peak) < X.nbytes // len(devs):
            raise AssertionError("a mesh device never held its row shard")


def precision_probe():
    """Does a float32 product at default precision run in TF32 here?
    Relative error against float64 of a 2048^2 product and a matvec."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.normal(size=(2048, 2048)).astype(np.float32)
    v = rng.normal(size=(2048,)).astype(np.float32)
    exact = a.astype(np.float64) @ a.astype(np.float64)
    exact_v = a.astype(np.float64) @ v.astype(np.float64)
    for name, prec in (("default", None),
                       ("highest", jax.lax.Precision.HIGHEST)):
        mm = np.asarray(jnp.dot(a, a, precision=prec), np.float64)
        mv = np.asarray(jnp.dot(a, v, precision=prec), np.float64)
        log(f"  f32 precision={name}: matmul rel err "
            f"{np.abs(mm - exact).max() / np.abs(exact).max():.2e}, matvec "
            f"rel err {np.abs(mv - exact_v).max() / np.abs(exact_v).max():.2e}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    from admm_tpu.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    import jax

    devices = jax.devices()
    check_device(devices, args.chips)
    log(f"card: {card_name_and_power()}")
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
        f"compile cache {cache_dir}")
    timer = CompileTimer()
    t_all = time.perf_counter()

    if args.chips == 4:
        from admm_tpu.parallel.mesh import make_mesh

        phases = [("mesh: consensus + data_mesh lasso path, 10000 x 1000, "
                   "4 cards", phase_mesh,
                   (*regression_problem(10000, 1000, 100),
                    make_mesh(4, devices=devices[:4])))]
    else:
        X, y = regression_problem(10000, 1000, 100)
        phases = [
            ("precision probe", precision_probe, ()),
            ("lasso: 10000 x 1000, 100 lambdas", phase_lasso, (X, y, timer)),
            ("enet: alpha 0.6, same data", phase_enet, (X, y)),
            ("wide: 1000 x 2000", phase_wide,
             regression_problem(1000, 2000, 100)),
            ("lad: 1000 x 500 against linprog", phase_lad,
             lad_problem(1000, 500)),
            ("bp: 1000 x 2000, 100 signals", phase_bp,
             bp_problem(1000, 2000, 100, 100)),
            ("logistic: 2000 x 200, 30 lambdas", phase_logistic,
             logistic_problem(2000, 200)),
        ]
    for label, fn, fargs in phases:
        log(f"phase {label}")
        t0 = time.perf_counter()
        fn(*fargs)
        log(f"  phase time {time.perf_counter() - t0:.1f} s")

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s "
        f"(compile {timer.seconds:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
