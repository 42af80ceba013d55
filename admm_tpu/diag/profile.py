"""Profiler integration (SURVEY.md section 5).

The reference's only profiling hook is a wall-clock ``#if ADMM_PROFILE``
block in an uncompiled file (reference: src/TODO/ParBP.cppp:29-32).
Here profiling is first-class via ``jax.profiler``: traces capture XLA
op-level timing (and the GPU's kernel timeline when run on device) and are
viewable in TensorBoard or Perfetto.

Usage::

    from admm_tpu.diag.profile import trace, annotate

    with trace("/tmp/admm-profile"):
        admm_tpu.admm_lasso(X, y).fit()

    with annotate("lambda-path"):          # label a region in the trace
        lasso_path(X, y)
"""
from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False):
    """Capture a jax.profiler trace of the enclosed block into ``logdir``.

    The directory can be opened with TensorBoard (``tensorboard
    --logdir=...``) or uploaded to ui.perfetto.dev.  Blocks until all
    enclosed device work is complete so the trace is complete.
    """
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        # Flush in-flight async device work into the trace: devices
        # execute their streams in order, so blocking on a trivial op
        # enqueued now implies everything dispatched inside the block
        # has completed (effects_barrier alone only covers ordered
        # side effects, not async computations).
        try:
            import jax.numpy as jnp

            (jnp.zeros(()) + 0.0).block_until_ready()
        except Exception:
            pass
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region in the profiler timeline (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_profile(path: str) -> None:
    """Write a pprof-format device memory snapshot to ``path``."""
    with open(path, "wb") as f:
        f.write(jax.profiler.device_memory_profile())
