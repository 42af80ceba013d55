"""Checkpoint / resume for lambda-path solves.

The reference has no cross-process checkpointing; *within* a run the
lambda-path warm-start protocol is its resume mechanism
(reference: src/ADMMLassoTall.h:219-230, SURVEY.md section 5).  The
design makes the natural next step trivial: the entire solver
state is an :class:`~admm_tpu.core.engine.ADMMState` pytree of arrays, so
a path solve can be chunked, with the terminal state of each chunk saved
to disk, and resumed bit-exactly after a crash — the data-derived caches
(standardization stats, Gram matrices, factorizations, auto-rho) are
deterministic functions of (X, y, options) and are rebuilt on resume
rather than stored.

Usage::

    res = checkpointed_lasso_path(X, y, lambdas=lams,
                                  checkpoint="/tmp/run.npz", chunk_size=10)

If the process dies mid-path, calling again with the same arguments skips
the completed chunks (warm-starting from the saved state) and returns the
identical result a single uninterrupted solve would have produced.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..data.standardize import recover, standardize
from ..models.lasso import (PathResult, _scan_path, _tall_engine,
                            _wide_engine)

_STATE_PREFIX = "state__"


def save_pytree(path: str, tree, **extras) -> None:
    """Serialize a pytree of arrays (plus named numpy extras) to ``.npz``.

    Leaves are keyed by their flattened position; ``None`` leaves are
    recorded so the structure round-trips.  The write is atomic (tmp file
    + rename) so a crash mid-save never corrupts an existing checkpoint.
    """
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: x is None)
    payload = {}
    for i, leaf in enumerate(leaves):
        key = f"{_STATE_PREFIX}{i}"
        payload[key] = (np.asarray(False) if leaf is None
                        else np.asarray(leaf))
        payload[key + "__none"] = np.asarray(leaf is None)
    payload.update(extras)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like):
    """Load a pytree saved by :func:`save_pytree`, shaped ``like`` the
    given template pytree.  Returns ``(tree, extras_dict)``."""
    with np.load(path) as data:
        treedef = jax.tree.structure(like, is_leaf=lambda x: x is None)
        leaves = []
        i = 0
        while f"{_STATE_PREFIX}{i}" in data:
            if bool(data[f"{_STATE_PREFIX}{i}__none"]):
                leaves.append(None)
            else:
                leaves.append(jnp.asarray(data[f"{_STATE_PREFIX}{i}"]))
            i += 1
        extras = {k: data[k] for k in data.files
                  if not k.startswith(_STATE_PREFIX)}
    return jax.tree.unflatten(treedef, leaves), extras


def _fingerprint(Xs, ys, lams, alpha, maxit, eps_abs, eps_rel, rho,
                 standardize_x, intercept, enet_scale, *, model="lasso",
                 extra_arrays=()):
    """Problem identity so a checkpoint is never resumed against a
    different problem, model or options.  Every option that changes
    solver behavior must appear here — including the static flags
    (enet_scale changes the wide regime's lambda0 early-exit threshold)
    and the ``model`` family tag.  The data and the full lambda grid
    (plus model-specific ``extra_arrays`` such as group assignments)
    enter as a SHA-256 over their bytes: shape plus a couple of sample
    sums is not identity (a change to an interior row of X, or a
    different interior grid with the same endpoints, must refuse to
    resume).  The hash is one streaming pass over host memory —
    negligible next to a single solve chunk."""
    import hashlib

    h = hashlib.sha256()
    h.update(model.encode())
    for arr in (Xs, ys, lams) + tuple(extra_arrays):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
        h.update(a.tobytes())
    # Fold the 256-bit digest into four float64 lanes so the fingerprint
    # stays a flat float array (backwards-compatible container format).
    digest = np.frombuffer(h.digest(), dtype=np.uint64).astype(np.float64)
    return np.concatenate([np.array([
        Xs.shape[0], Xs.shape[1], lams.shape[0],
        float(alpha), float(maxit), float(eps_abs), float(eps_rel),
        float(rho), float(standardize_x), float(intercept),
        float(enet_scale),
    ], dtype=np.float64), digest])


def checkpointed_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        _enet_scale: bool = False, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Lasso/Enet lambda path solved in resumable chunks.

    Semantically identical to
    :func:`admm_tpu.models.lasso.lasso_path` with explicit ``lambdas``
    (the warm-start chain is the same chain, just cut at chunk
    boundaries), but after every ``chunk_size`` lambdas the solver state
    and accumulated results are written to ``checkpoint``.  On a rerun,
    completed chunks are skipped.  The checkpoint file is deleted on
    successful completion.

    ``_stop_after_chunks`` is a fault-injection hook for tests: abandon
    the run (returning None) after that many chunks.
    """
    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / stats.scale_y

    if n > p:
        st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho, alpha)
    else:
        st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho, alpha,
                                          _enet_scale)

    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, _enet_scale)
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def _validate_chunking(chunk_size, lambdas):
    if int(chunk_size) < 1:
        raise ValueError("chunk_size must be >= 1")
    lambdas = np.asarray(lambdas)
    if lambdas.size < 1:
        raise ValueError("lambdas must be non-empty")
    return int(chunk_size), lambdas


def _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel, *, fp,
                  checkpoint, chunk_size, _stop_after_chunks=None):
    """The generic chunk/save/resume loop shared by every checkpointed
    path driver.  ``segment(st, ilams_chunk, maxit, eps_abs, eps_rel) ->
    (st, coefs, niter)`` advances the warm-start chain over one chunk.
    Returns ``(coefs, niter)`` jnp arrays, or None if the fault-injection
    hook abandoned the run.  Deletes the checkpoint on completion.
    """
    nlam = int(ilams.shape[0])
    k_done = 0
    coefs_done = []
    niter_done = []
    st = st0
    if os.path.exists(checkpoint):
        st_loaded, extras = load_pytree(checkpoint, st0)
        fp_old = np.asarray(extras["fingerprint"])
        # The trailing 4 lanes are the SHA-256 content digest: compared
        # EXACTLY — allclose's rtol would discard ~47 bits of a ~1e19
        # lane and defeat the content-hash identity (advisor finding
        # r2).  The option fields keep the float tolerance.
        if (fp_old.shape != fp.shape
                or not np.array_equal(fp_old[-4:], fp[-4:])
                or not np.allclose(fp_old[:-4], fp[:-4])):
            raise ValueError(
                f"checkpoint {checkpoint!r} belongs to a different "
                "problem/options; refusing to resume")
        st = st_loaded
        k_done = int(extras["k_done"])
        coefs_done = [extras["coefs"]]
        niter_done = [extras["niter"]]

    chunks_run = 0
    while k_done < nlam:
        if (_stop_after_chunks is not None
                and chunks_run >= _stop_after_chunks):
            return None
        hi = min(k_done + chunk_size, nlam)
        st, coefs, niter = segment(st, ilams[k_done:hi],
                                   maxit, eps_abs, eps_rel)
        jax.block_until_ready(st)
        coefs_done.append(np.asarray(coefs))
        niter_done.append(np.asarray(niter))
        k_done = hi
        chunks_run += 1
        save_pytree(checkpoint, st, fingerprint=fp,
                    k_done=np.asarray(k_done),
                    coefs=np.concatenate(coefs_done, axis=0),
                    niter=np.concatenate(niter_done, axis=0))

    coefs = jnp.asarray(np.concatenate(coefs_done, axis=0))
    niter = jnp.asarray(np.concatenate(niter_done, axis=0))
    if os.path.exists(checkpoint):
        os.unlink(checkpoint)
    return coefs, niter


def checkpointed_dantzig_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Dantzig-selector lambda path in resumable chunks (same protocol
    as :func:`checkpointed_lasso_path`; the Dantzig state pytree already
    exists, only the engine differs —
    admm_tpu/models/dantzig.py::_dantzig_engine)."""
    from ..models.dantzig import _dantzig_engine

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / stats.scale_y

    st0, solve, report = _dantzig_engine(Xs, ys, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="dantzig")
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_group_lasso_path(
        X, y, groups, *, lambdas, checkpoint: str, chunk_size: int = 10,
        weights=None, standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Group-Lasso lambda path in resumable chunks.  ``groups`` and
    ``weights`` enter the fingerprint (a different grouping must refuse
    to resume)."""
    from ..models.grouplasso import (_gl_tall_engine, _gl_wide_engine,
                                     _GroupProblem, normalize_groups)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    groups_j, weights_j = normalize_groups(groups, p, weights, dtype)
    gp = _GroupProblem(groups=groups_j, weights=weights_j)
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / stats.scale_y

    if n > p:
        st0, solve, report = _gl_tall_engine(Xs, ys, ilams[0], rho, gp)
    else:
        st0, solve, report = _gl_wide_engine(Xs, ys, ilams[0], rho, gp)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="group",
                      extra_arrays=(groups_j, weights_j))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_glm_path(
        X, y, family, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, hessian: str = "auto", weights=None,
        dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Penalized-GLM lambda path (any family) in resumable chunks —
    same protocol as :func:`checkpointed_lasso_path`; the GLM engine
    already exposes the ``(st0, solve, report)`` triple that
    ``_chunked_scan`` consumes (admm_tpu/models/glm.py::_glm_engine).
    The family name, hessian mode, newton_steps and the observation
    weights all enter the fingerprint."""
    from ..models.glm import (GLMFamily, _glm_engine, prep_design,
                              recover_glm)

    fam = family() if not isinstance(family, GLMFamily) else family
    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype).ravel()
    n, p = X.shape
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept,
                                             weights=w)
    # GLM paths run on USER-scale lambdas (the 1/n rides inside the
    # loss gradient; models/glm.py::_glm_path).
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    if hessian == "auto":
        # Checkpointed runs keep the exact engine for unbounded
        # families: the adaptive majorizer's per-lambda refresh anchors
        # on in-chunk warm starts and its aux does not cross chunk
        # boundaries.
        hessian = ("fixed" if fam.curvature_bound is not None
                   else "exact")
    if hessian == "adaptive":
        raise ValueError("checkpointed GLM paths support hessian="
                         "'fixed' or 'exact' (the adaptive majorizer's "
                         "aux does not cross chunk boundaries)")
    if hessian not in ("fixed", "exact"):
        raise ValueError(f"unknown hessian mode {hessian!r}")
    st0, solve, report, _refresh = _glm_engine(
        Xa, y, fam, lams[0], rho, pen_mask, alpha, int(newton_steps),
        obs_w=w, hessian=hessian)
    fp = _fingerprint(
        Xa, y, lams, alpha, maxit, eps_abs, eps_rel, rho,
        standardize, intercept, False,
        # fam.param distinguishes parametrized likelihoods — huber(M),
        # negative_binomial(theta) — whose name alone would collide.
        model=(f"glm-{fam.name}-p{float(fam.param)!r}-{hessian}"
               f"-ns{int(newton_steps)}"),
        extra_arrays=(() if w is None else (w,)))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_a, niter = out
    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_gen_lasso_path(
        X, y, D, *, lambdas, checkpoint: str, chunk_size: int = 10,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Generalized-Lasso lambda path in resumable chunks.  The penalty
    matrix ``D`` enters the fingerprint (a different structure matrix
    must refuse to resume)."""
    from ..models.genlasso import _genlasso_engine

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    D = jnp.asarray(D, dtype)
    n, p = X.shape
    if intercept:
        mean_x = jnp.mean(X, axis=0)
        mean_y = jnp.mean(y)
        Xs = X - mean_x[None, :]
        ys = y - mean_y
    else:
        Xs, ys = X, y
        mean_x = jnp.zeros((p,), dtype)
        mean_y = jnp.asarray(0.0, dtype)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n

    st0, solve, report = _genlasso_engine(Xs, ys, D, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      False, intercept, False, model="genlasso",
                      extra_arrays=(D,))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs, niter=niter)


def checkpointed_parallel_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        nworkers: Optional[int] = None, mesh=None, alpha: float = 1.0,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, _enet_scale: bool = False, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Consensus (parallel) Lasso/Enet lambda path in resumable chunks.

    The consensus resume state is ``(x (W, p), y (W, p), z (p,), rho)``
    — gathered from the mesh at each chunk boundary and re-sharded on
    resume (admm_tpu/parallel/consensus.py::_consensus_shard takes the
    starting iterates explicitly).  rho is set once at the path's first
    lambda (reference: src/PADMMLasso.h:199-200) and carried through the
    checkpoint so a resumed run matches an uninterrupted one.
    """
    from functools import partial as _partial

    from ..parallel.consensus import (_consensus_lasso_shard,
                                      _partition_rows, _resolve_mesh,
                                      _run_consensus)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / stats.scale_y
    Xb, yb, rows_w = _partition_rows(Xs, ys, W)
    solver = _partial(_consensus_lasso_shard, nworkers=W,
                      tall_block=rows_w >= p, alpha=float(alpha),
                      group_prox=None)

    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, _enet_scale,
                      model=f"consensus-lasso-W{W}")
    st0 = (jnp.zeros((W, p), dtype), jnp.zeros((W, p), dtype),
           jnp.zeros((p,), dtype), jnp.asarray(rho, dtype))

    def segment(st, il, m, ea, er):
        x, yd, z, rho_c = st
        coefs, niter, (x2, y2, z2, rho2) = _run_consensus(
            Xb, yb, il, rho_c, m, ea, er, mesh=mesh, axis=axis, D=D,
            solver=solver, init=(x, yd, z))
        return (np.asarray(x2), np.asarray(y2), np.asarray(z2),
                np.asarray(rho2)), coefs, niter

    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_multitask_lasso_path(
        X, Y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize_x: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, penalty: str = "rows", dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Multi-task Lasso lambda path in resumable chunks (same protocol
    as :func:`checkpointed_lasso_path`; the (p, K) coefficient-matrix
    state rides the pytree container unchanged).  ``penalty="nuclear"``
    checkpoints the reduced-rank (trace-norm) path — the penalty tag
    enters the fingerprint."""
    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    from ..models.multitask import (MTPathResult, _mt_engine,
                                    mt_recover, mt_standardize)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    Y = jnp.asarray(Y, dtype)
    n, p = X.shape
    K = Y.shape[1]
    Xs, Ys, sd_x, sd_y, mean_x, mean_y, _w = mt_standardize(
        X, Y, standardize_x=standardize_x, intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n

    st0, solve, report = _mt_engine(Xs, Ys, ilams[0], rho,
                                    penalty=penalty)
    fp = _fingerprint(Xs, Ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False,
                      model=f"multitask-{penalty}")
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = mt_recover(coefs, sd_x, sd_y, mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter)


def checkpointed_multinomial_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        nclass: Optional[int] = None, alpha: float = 1.0,
        grouped: bool = False, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Sparse multinomial lambda path in resumable chunks.  The penalty
    style (grouped flag) and class count enter the fingerprint's model
    tag; labels enter via the hashed data."""
    from ..models.glm import prep_design
    from ..models.multinomial import MNPathResult, _mn_engine

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y_np = np.asarray(y).ravel()
    if nclass is None:
        nclass = int(y_np.max()) + 1
    C = int(nclass)
    n, p = X.shape
    Yoh = jax.nn.one_hot(jnp.asarray(y_np.astype(np.int32)), C,
                         dtype=dtype)
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]

    st0, solve, report = _mn_engine(Xa, Yoh, lams[0], rho, pen_mask,
                                    alpha, bool(grouped),
                                    int(newton_steps))
    fp = _fingerprint(
        Xa, Yoh, lams, alpha, maxit, eps_abs, eps_rel, rho,
        standardize_x, intercept, False,
        model=f"multinomial-C{C}-{'grouped' if grouped else 'enet'}"
              f"-ns{int(newton_steps)}")
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_a, niter = out
    from ..models.multinomial import mn_recover

    beta0, coef = mn_recover(coefs_a, sd_x, mean_x, C, intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter)


def checkpointed_slope_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        lam_seq=None, q: float = 0.1, standardize_x: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """SLOPE scale-path (``lambdas`` = the t values) in resumable
    chunks.  The sorted penalty sequence enters the fingerprint (a
    different sequence must refuse to resume)."""
    from ..models.slope import _slope_engine, bh_sequence

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    lam_j = jnp.asarray(np.asarray(lam_seq, np.float64).ravel(), dtype)
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept)
    ts = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    its = ts * n / stats.scale_y

    st0, solve, report, _ = _slope_engine(Xs, ys, lam_j, its[0], rho)
    fp = _fingerprint(Xs, ys, its, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize_x, intercept, False, model="slope",
                      extra_arrays=(lam_j,))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, its, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=ts, beta0=beta0, coef=coef, niter=niter)


def checkpointed_glasso_path(
        X=None, *, cov=None, lambdas, checkpoint: str,
        chunk_size: int = 5, weights=None,
        penalize_diagonal: bool = False, assume_centered: bool = False,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, xupdate: str = "newton", dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Graphical-lasso lambda path in resumable chunks — the warm-started
    scan over the (p, p) matrix state (models/glasso.py); the covariance
    matrix, penalty convention and x-update choice enter the
    fingerprint.  The adaptive rho rides the saved state, so a resumed
    run continues the same ladder bit-exactly."""
    from ..models.glasso import (GlassoResult, _glasso_engine,
                                 empirical_covariance)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    if (X is None) == (cov is None):
        raise ValueError("pass exactly one of X or cov")
    if cov is not None:
        S = jnp.asarray(cov, dtype)
    else:
        S = empirical_covariance(X, weights, dtype=dtype,
                                 assume_centered=assume_centered)
    p = S.shape[-1]
    eye = jnp.eye(p, dtype=dtype)
    pen_mask = (jnp.ones((p, p), dtype) if penalize_diagonal
                else 1.0 - eye)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]

    st0, solve, report = _glasso_engine(S, pen_mask, lams[0], rho,
                                        xupdate)
    fp = _fingerprint(S, jnp.zeros((1,), dtype), lams, 1.0, maxit,
                      eps_abs, eps_rel, rho, False, False,
                      penalize_diagonal, model="glasso-" + xupdate)
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    precs, niter = out
    return GlassoResult(lambdas=lams, precision=precs, cov=S,
                        niter=niter)


def checkpointed_svm_path(
        X, y, *, Cs, checkpoint: str, chunk_size: int = 5,
        loss: str = "squared_hinge", intercept: bool = True,
        weights=None, maxit: int = 20000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Linear-SVM C path in resumable chunks (the warm-started scan
    protocol of models/svm.py).  The loss, intercept flag, labels and
    per-row weights enter the fingerprint; auto-rho is derived from the
    FULL C grid (as in the one-shot path), so chunking never changes
    the shared factorization."""
    from ..models.svm import SVMResult, _as_sign, _svm_engine

    chunk_size, Cs_np = _validate_chunking(chunk_size, Cs)
    ysign, classes = _as_sign(y)
    X = jnp.asarray(X, dtype)
    n, p = X.shape
    obs_w = (jnp.ones((n,), dtype) if weights is None
             else jnp.asarray(weights, dtype).ravel())
    Cs_d = jnp.sort(jnp.asarray(Cs_np, dtype))[::-1]
    ysign_d = jnp.asarray(ysign, dtype)

    st0, solve, report = _svm_engine(X, ysign_d, Cs_d, obs_w, loss,
                                     bool(intercept), rho)
    fp = _fingerprint(X, ysign_d, Cs_d, 1.0, maxit, eps_abs, eps_rel,
                      rho, False, intercept, False,
                      model=f"svm-{loss}", extra_arrays=(obs_w,))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, Cs_d, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    vs, niter = out
    if intercept:
        coefs, b = vs[:, :p], vs[:, p]
    else:
        coefs, b = vs, jnp.zeros((Cs_d.shape[0],), dtype)
    return SVMResult(Cs=Cs_d, coef=coefs, intercept=b, niter=niter,
                     classes=classes)


def checkpointed_cox_path(
        X, time, event, *, lambdas, checkpoint: str, chunk_size: int = 10,
        alpha: float = 1.0, standardize: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, newton_steps: int = 2, weights=None,
        offset=None, strata=None, start=None, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Cox partial-likelihood lambda path in resumable chunks — the
    warm-started scan with the per-lambda adaptive majorizer
    (models/cox.py), chunked via ``_scan_path``'s refresh hook so the
    checkpointed run equals the one-shot scan.  The sorted times (which
    define the risk sets), weights, offset, strata codes and entry
    times all enter the fingerprint."""
    from ..core.engine import make_admm_solver, make_state
    from ..models.cox import (CoxPathResult, _cox_majorizer_inv,
                              _cox_ops, _cox_standardize,
                              _startstop_prep, _strata_prep,
                              _tie_groups)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X_np = np.asarray(X, np.float64)
    t_np = np.asarray(time, np.float64).ravel()
    d_np = np.asarray(event, np.float64).ravel()
    n, p = X_np.shape
    seg = ext = None
    extra = []
    if start is not None:
        st_np = np.asarray(start, np.float64).ravel()
        if st_np.shape != (n,):
            raise ValueError("start must have one entry per row")
        if np.any(st_np >= t_np):
            raise ValueError("start must be < time")
    if strata is None:
        order = np.argsort(-t_np, kind="stable")
        first, last = _tie_groups(t_np[order])
        tag = "cox"
        if start is not None:
            ext = _startstop_prep(t_np[order], st_np[order])
            extra.append(jnp.asarray(st_np[order], dtype))
            tag = "cox-startstop"
    else:
        from ..models.cox import _startstop_prep_strata

        order, ss, seg_first, seg_last = _strata_prep(t_np, strata)
        first, last = _tie_groups(t_np[order], ss)
        seg = (seg_first, seg_last)
        extra.append(jnp.asarray(ss.astype(np.float64), dtype))
        tag = "cox-strata"
        if start is not None:
            ext = _startstop_prep_strata(t_np[order], st_np[order],
                                         np.asarray(ss))
            extra.append(jnp.asarray(st_np[order], dtype))
            tag = "cox-strata-startstop"
    Xj = jnp.asarray(X_np[order], dtype)
    dj = jnp.asarray(d_np[order], dtype)
    extra.insert(0, jnp.asarray(t_np[order], dtype))
    w = off = None
    if weights is not None:
        w = jnp.asarray(np.asarray(weights, np.float64).ravel()[order],
                        dtype)
        w = w * (n / jnp.sum(w))
        extra.append(w)
    if offset is not None:
        off = jnp.asarray(np.asarray(offset, np.float64).ravel()[order],
                          dtype)
        extra.append(off)
    wc = jnp.ones((n,), dtype) if w is None else w
    Xs, sd_x = _cox_standardize(Xj, wc, n, standardize)
    rho_j = jnp.where(rho > 0, jnp.asarray(rho, dtype),
                      jnp.asarray(0.5, dtype))
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]

    ops = _cox_ops(Xs, dj, first, last, n, p, alpha, int(newton_steps),
                   None, None, None, off, w, seg, ext)
    solve = make_admm_solver(ops, adapt_rho=False)

    def refresh(b):
        return _cox_majorizer_inv(b, Xs, dj, first, last, n, rho_j, w,
                                  off, seg, ext)

    zeros = jnp.zeros((p,), dtype)
    st0 = make_state(zeros, zeros, zeros, rho_j, lams[0],
                     aux=refresh(zeros), dtype=dtype)
    fp = _fingerprint(Xs, dj, lams, alpha, maxit, eps_abs, eps_rel,
                      rho, standardize, False, False,
                      model=f"{tag}-ns{int(newton_steps)}",
                      extra_arrays=tuple(extra))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, (lambda s: s.z), il, m, ea, er,
        refresh=refresh)[:3])
    out = _chunked_scan(st0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs_s, niter = out
    return CoxPathResult(lambdas=lams, coef=coefs_s / sd_x[None, :],
                         niter=niter)


def checkpointed_sqrt_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        standardize: bool = True, intercept: bool = True, weights=None,
        maxit: int = 10000, eps_abs: float = 1e-6, eps_rel: float = 1e-6,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Square-root-lasso path in resumable chunks — the CONCOMITANT
    warm-started scan (models/sqrtlasso.py): the saved state carries
    both the inner FADMM iterates and the sigma estimate, so a resumed
    chain continues the same alternation bit-exactly."""
    from ..models.sqrtlasso import (_sqrt_concomitant_scan_setup,
                                    _sqrt_prepare)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    w = None if weights is None else jnp.asarray(weights, dtype)
    Xs, ys, sd_x, mean_x, mean_y = _sqrt_prepare(
        X, y, w, standardize_x=standardize, intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]

    carry0, make_step = _sqrt_concomitant_scan_setup(Xs, ys, lams[0],
                                                     rho)
    fp = _fingerprint(Xs, ys, lams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize, intercept, False, model="sqrtlasso")

    def _seg(carry, il, m, ea, er):
        carry, (coefs, niter) = jax.lax.scan(make_step(m, ea, er),
                                             carry, il)
        return carry, coefs, niter

    segment = jax.jit(_seg)
    out = _chunked_scan(carry0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    coef = coefs / sd_x[None, :]
    beta0 = mean_y - coef @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter)


def checkpointed_constrained_lasso_path(
        X, y, C, d=None, *, lambdas, checkpoint: str,
        chunk_size: int = 10, intercept: bool = True, weights=None,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None) -> Optional[PathResult]:
    """Equality-constrained lasso path in resumable chunks — the
    warm-started scan on the block-eliminated KKT engine
    (models/conlasso.py).  The constraint matrix and right-hand side
    enter the fingerprint."""
    from ..models.conlasso import _conlasso_engine
    from ..models.genlasso import center_weight

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    C = jnp.atleast_2d(jnp.asarray(C, dtype))
    if C.shape[1] != X.shape[1]:
        raise ValueError("C must be (m, ncol(x))")
    d = (jnp.zeros((C.shape[0],), dtype) if d is None
         else jnp.asarray(d, dtype).ravel())
    n = X.shape[0]
    w = None if weights is None else jnp.asarray(weights, dtype)
    Xs, ys, mean_x, mean_y = center_weight(X, y, w, intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n

    st0, solve, report = _conlasso_engine(Xs, ys, C, d, ilams[0], rho)
    fp = _fingerprint(Xs, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      False, intercept, False, model="conlasso",
                      extra_arrays=(C, d))
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs,
                      niter=niter)


def checkpointed_relaxed_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        gammas=(0.0, 0.25, 0.5, 0.75, 1.0), alpha: float = 1.0,
        standardize: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5, eps_rel: float = 1e-5,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Relaxed-lasso (lambda, gamma) grid in resumable chunks: each
    chunk advances the lasso warm-start chain AND computes that chunk's
    unpenalized support refits (models/relaxed.py::_masked_refits), so
    a resumed run re-does neither.  The gamma blend is affine and
    applied once at the end."""
    from ..data.standardize import standardize as _std
    from ..models.relaxed import RelaxedPathResult, _masked_refits

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    gam = jnp.sort(jnp.asarray(gammas, dtype).ravel())
    Xs, ys, stats = _std(X, y, standardize_x=standardize,
                         intercept=intercept)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / stats.scale_y

    if n > p:
        st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho, alpha)
    else:
        st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho, alpha,
                                          False)
    fp = _fingerprint(Xs, ys, ilams, alpha, maxit, eps_abs, eps_rel,
                      rho, standardize, intercept, False,
                      model="relaxed", extra_arrays=(gam,))

    def _seg(st, il, m, ea, er):
        st, coefs, niter, _ = _scan_path(st, solve, report, il, m, ea,
                                         er)
        supp = (jnp.abs(coefs) > 0).astype(dtype)
        rb0, rcoef = _masked_refits(X, y, supp, None,
                                    standardize_x=standardize,
                                    intercept=intercept)
        # Pack per-lambda [std lasso coef | original-scale refit coef |
        # refit intercept] so the generic chunk loop carries ONE array.
        packed = jnp.concatenate([coefs, rcoef, rb0[:, None]], axis=1)
        return st, packed, niter

    segment = jax.jit(_seg)
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    packed, niter = out
    coefs_std = packed[:, :p]
    refit_coef = packed[:, p:2 * p]
    refit_beta0 = packed[:, 2 * p]
    beta0_l, coef_l = recover(stats, coefs_std,
                              standardize_x=standardize,
                              intercept=intercept)
    fit = PathResult(lambdas=lams, beta0=beta0_l, coef=coef_l,
                     niter=niter)
    g = gam[:, None, None]
    coef = g * coef_l[None] + (1.0 - g) * refit_coef[None]
    beta0 = (gam[:, None] * beta0_l[None]
             + (1.0 - gam[:, None]) * refit_beta0[None])
    return RelaxedPathResult(lambdas=lams, gammas=gam, beta0=beta0,
                             coef=coef, fit=fit,
                             refit_beta0=refit_beta0,
                             refit_coef=refit_coef)


def checkpointed_quantile_lasso_path(
        X, y, *, lambdas, checkpoint: str, chunk_size: int = 10,
        tau=0.5, standardize: bool = True, intercept: bool = True,
        weights=None, maxit: int = 20000, eps_abs: float = 1e-6,
        eps_rel: float = 1e-6, rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """Penalized quantile (tau x lambda) grid in resumable chunks — the
    warm-started per-tau scans advance together over lambda chunks
    (every tau's FADMM state is a lane of the saved pytree; tau rides
    state.aux as in the one-shot driver).  The tau grid and weights
    enter the fingerprint; the shared explicit lambda grid is the
    checkpoint-driver convention."""
    from ..core.engine import make_fadmm_solver, make_state, warm_start
    from ..models.quantile import (QuantilePathResult, _quantile_ops,
                                   _quantile_prepare, _quantile_setup)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    taus = jnp.atleast_1d(jnp.asarray(tau, dtype))
    t_np = np.asarray(taus, np.float64)
    if np.any(t_np <= 0) or np.any(t_np >= 1):
        raise ValueError("tau values must be in (0, 1)")
    T = taus.shape[0]
    w = None if weights is None else jnp.asarray(weights, dtype)
    Xs, ys, wrow, sd_x, sd_y, mean_x, mean_y = _quantile_prepare(
        X, y, w, standardize_x=standardize, intercept=intercept)
    Xa, pf, q, Minv, rho_j = _quantile_setup(Xs, ys, intercept, rho)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    ilams = lams * n / sd_y

    ops = _quantile_ops(Xa, ys, Minv, wrow, pf, n, q)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    znq = jnp.zeros((n + q,), dtype)
    st0 = jax.vmap(lambda t: make_state(
        jnp.zeros((q,), dtype), znq, znq, rho_j, ilams[0],
        aux=(t, jnp.zeros((n,), dtype)), dtype=dtype))(taus)
    fp = _fingerprint(Xa, ys, ilams, 1.0, maxit, eps_abs, eps_rel, rho,
                      standardize, intercept, False, model="quantile",
                      extra_arrays=(taus, wrow))

    def _seg(sts, il, m, ea, er):
        def one_tau(st):
            def step(st, lam):
                st = warm_start(st, lam)
                st = solve(st, m, ea, er)
                return st, (st.z[n:], st.it)

            return jax.lax.scan(step, st, il)

        sts, (coefs, niter) = jax.vmap(one_tau)(sts)
        # Leading axis must be the CHUNKED lambda axis for the generic
        # chunk loop's concatenation.
        return sts, jnp.swapaxes(coefs, 0, 1), jnp.swapaxes(niter, 0, 1)

    segment = jax.jit(_seg)
    out = _chunked_scan(st0, segment, ilams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    coefs, niter = out
    coefs = jnp.swapaxes(coefs, 0, 1)      # (T, L, q)
    niter = jnp.swapaxes(niter, 0, 1)
    if intercept:
        a, slopes = coefs[..., 0], coefs[..., 1:]
        coef = slopes / sd_x * sd_y
        beta0 = mean_y + sd_y * a - jnp.sum(coef * mean_x, axis=-1)
    else:
        coef = coefs / sd_x * sd_y
        beta0 = jnp.zeros(coef.shape[:-1], dtype)
    lam_grid = jnp.broadcast_to(lams[None, :], (T, lams.shape[0]))
    return QuantilePathResult(taus=taus, lambdas=lam_grid, beta0=beta0,
                              coef=coef, niter=niter)


def checkpointed_rpca_path(
        M, *, lambdas, checkpoint: str, chunk_size: int = 3,
        observed=None, rank: Optional[int] = None, power_iters: int = 2,
        maxit: int = 5000, eps_abs: float = 1e-7, eps_rel: float = 1e-6,
        rho: float = -1.0, dtype=jnp.float32,
        _stop_after_chunks: Optional[int] = None):
    """PCP sparsity-penalty path in resumable chunks — the warm-started
    scan over the (L, S, Y) matrix state (models/rpca.py), with the
    partial-SVT warm basis riding the saved state when ``rank`` is
    given.  The data, mask, rank/power_iters options and grid enter the
    fingerprint."""
    from ..models.rpca import (RPCAPathResult, _check_mask,
                               _rpca_engine)

    chunk_size, lambdas = _validate_chunking(chunk_size, lambdas)
    M = jnp.asarray(M, dtype)
    if M.ndim != 2:
        raise ValueError("M must be a 2-D matrix")
    M0, mask = _check_mask(M, observed)
    lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]

    st0, solve, report = _rpca_engine(
        M0, lams[0], jnp.asarray(rho, dtype), mask,
        None if rank is None else int(rank), int(power_iters))
    tag = (f"rpca-r{int(rank)}-q{int(power_iters)}" if rank is not None
           else "rpca")
    extra = () if mask is None else (mask.astype(dtype),)
    fp = _fingerprint(M0, jnp.zeros((1,), dtype), lams, 1.0, maxit,
                      eps_abs, eps_rel, rho, False, False, False,
                      model=tag, extra_arrays=extra)
    segment = jax.jit(lambda st, il, m, ea, er: _scan_path(
        st, solve, report, il, m, ea, er)[:3])
    out = _chunked_scan(st0, segment, lams, maxit, eps_abs, eps_rel,
                        fp=fp, checkpoint=checkpoint,
                        chunk_size=chunk_size,
                        _stop_after_chunks=_stop_after_chunks)
    if out is None:
        return None
    LS, niter = out
    L, S = LS[:, 0], LS[:, 1]
    sv = jnp.linalg.svd(L, compute_uv=False)
    tol = (jnp.max(sv, axis=1, keepdims=True)
           * max(M.shape) * jnp.finfo(dtype).eps * 10)
    return RPCAPathResult(lambdas=lams, low_rank=L, sparse=S,
                          rank=jnp.sum(sv > tol, axis=1),
                          nnz=jnp.sum(S != 0, axis=(1, 2)),
                          niter=niter)
