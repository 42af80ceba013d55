"""Profile the XLA tall batch lasso path on the GPU.

    python benchmarks/trace_tall_batch.py [--out profile_out/tall_batch]

The flagship problem (10000 x 1000, 100 lambdas, seed 123) solved by the
batched-lane engine (``lasso_path(path_mode="batch")``'s jitted program)
with X and y already on the device.  Prints, and writes as JSON under
``--out``:

* wall time per solve (median of 5 warm calls, profiler off);
* from one traced solve: device busy time, the idle share of the traced
  solve's host window and of the device's own first-to-last-kernel span,
  the median ADMM iteration's period, busy time and kernel count (the
  batched loop runs max(niter) iterations), and the kernels that take
  the time;
* the per-iteration (K, p) x (p, p) product's kernel time against the
  same product, and a 4096^2 one, as plain ``Precision.HIGHEST`` float32
  matmuls timed in this process.

GPU only; the card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def interval_union_ns(intervals) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(pd, device="/device:GPU:0"):
    """(name, start_ns, end_ns) of every event on the device's stream
    lines (kernels and copies; the derived 'XLA Ops' lines are skipped)."""
    plane = pd.find_plane_with_name(device)
    if plane is None:
        raise RuntimeError(f"no {device} plane in the trace; planes: "
                           f"{[p.name for p in pd.planes]}")
    out = []
    for line in plane.lines:
        if not line.name.startswith("Stream"):
            continue
        for e in line.events:
            out.append((e.name, e.start_ns, e.end_ns))
    return out, [line.name for line in plane.lines]


def host_span(pd, name):
    for plane in pd.planes:
        if not plane.name.startswith("/host"):
            continue
        for line in plane.lines:
            for e in line.events:
                if e.name == name:
                    return e.start_ns, e.end_ns
    return None


def summarize(pd, annotation="tall_batch_solve"):
    """Busy time, idle shares and the per-iteration breakdown of one
    traced solve.  An iteration of an XLA:GPU while_loop ends with the
    device-to-host copy of its predicate, so consecutive ``MemcpyD2H``
    events delimit iterations."""
    evs, lines = device_events(pd)
    busy = interval_union_ns([(s, e) for _, s, e in evs])
    span = (min(s for _, s, _ in evs), max(e for _, _, e in evs))
    win = host_span(pd, annotation)
    d2h = sorted(e for n, _, e in evs if n == "MemcpyD2H")
    periods, busys, counts = [], [], []
    for a, b in zip(d2h, d2h[1:]):
        inside = [(s, e) for _, s, e in evs if s >= a and e <= b]
        periods.append(b - a)
        busys.append(interval_union_ns(inside))
        counts.append(len(inside))
    by_name = {}
    for name, s, e in evs:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + (e - s))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    loop_start = d2h[0] if d2h else span[1]
    return dict(
        device_lines=lines, n_device_events=len(evs),
        busy_ms=busy / 1e6, device_span_ms=(span[1] - span[0]) / 1e6,
        idle_share_device_span=1.0 - busy / (span[1] - span[0]),
        host_window_ms=None if win is None else (win[1] - win[0]) / 1e6,
        idle_share_host_window=(None if win is None
                                else 1.0 - busy / (win[1] - win[0])),
        predicate_copies=len(d2h),
        before_first_copy_busy_ms=interval_union_ns(
            [(s, e) for _, s, e in evs if e <= loop_start]) / 1e6,
        iteration_period_us=(float(np.median(periods)) / 1e3
                             if periods else None),
        iteration_busy_us=float(np.median(busys)) / 1e3 if busys else None,
        iteration_kernels=float(np.median(counts)) if counts else None,
        top_kernels=[dict(name=n[:160], count=c, total_ms=t / 1e6,
                          mean_us=t / c / 1e3) for n, (c, t) in top])


def timed(fn, *args, reps=5):
    """Median wall seconds of ``fn(*args)`` through block_until_ready."""
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out/tall_batch")
    args = ap.parse_args()

    from admm_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.profiler import ProfileData

    from admm_tpu.models.lasso import _path_auto
    from bench import make_problem

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; jax {jax.__version__} {dev.device_kind}")

    K, p = 100, 1000
    X, y = make_problem()
    X, y = jax.device_put(X, dev), jax.device_put(y, dev)

    def solve(X, y):
        return _path_auto(X, y, K, 1e-4, -1.0, 10000, 1e-5, 1e-5, 1.0,
                          standardize_x=True, intercept=True,
                          enet_scale=False, path_mode="batch")

    res = jax.block_until_ready(solve(X, y))
    niter = np.asarray(res.niter)
    wall_s = timed(solve, X, y)
    print(f"batch solve: wall {wall_s * 1e3:.3f} ms (median of 5, inputs on "
          f"device), niter max {int(niter.max())} total {int(niter.sum())}")

    # Plain HIGHEST f32 products for comparison, timed as K-rep loops.
    def mm_rate(m, k, n, reps):
        a = jnp.ones((m, k), jnp.float32)
        b = jnp.ones((k, n), jnp.float32) / k

        @jax.jit
        def loop(a, b):
            return lax.fori_loop(0, reps, lambda i, acc: jnp.dot(
                acc, b, precision=lax.Precision.HIGHEST), a)

        jax.block_until_ready(loop(a, b))
        t = timed(loop, a, b) / reps
        return t, 2.0 * m * k * n / t

    t_kp, r_kp = mm_rate(K, p, p, 2000)
    t_big, r_big = mm_rate(4096, 4096, 4096, 20)
    print(f"plain HIGHEST f32 ({K},{p})x({p},{p}): {t_kp * 1e6:.2f} us "
          f"({r_kp / 1e12:.2f} TFLOP/s); 4096^3: {t_big * 1e3:.3f} ms "
          f"({r_big / 1e12:.2f} TFLOP/s)")

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        with jax.profiler.TraceAnnotation("tall_batch_solve"):
            jax.block_until_ready(solve(X, y))
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    it = int(niter.max())
    out = dict(card=card, device_kind=dev.device_kind, jax=jax.__version__,
               wall_ms=wall_s * 1e3, niter_max=it,
               niter_total=int(niter.sum()),
               plain_kp_matmul_us=t_kp * 1e6, plain_kp_tflops=r_kp / 1e12,
               plain_4096_tflops=r_big / 1e12)
    out.update(summarize(ProfileData.from_file(path)))
    for k, v in out.items():
        if k != "top_kernels":
            print(f"{k}: {v}")
    for row in out["top_kernels"]:
        print(f"  {row['total_ms']:9.3f} ms  x{row['count']:6d}  "
              f"{row['mean_us']:8.2f} us  {row['name']}")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
