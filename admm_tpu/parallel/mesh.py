"""Device-mesh helpers for the consensus (parallel) ADMM solvers.

The reference's parallelism is OpenMP fork/join over row-block workers in
shared memory (reference: src/PADMMBase.h:180-213).  The accelerator
equivalent is a 1-D ``jax.sharding.Mesh`` over which the data matrix is
row-sharded; per-worker math becomes per-shard math under ``shard_map``
and the master's gather/reduce points become ``psum`` over the mesh axis
(an NCCL all-reduce across the GPUs).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "workers"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def row_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard a (n, ...) array along its leading (row/observation) axis."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_dim_sharded(arr, mesh: Mesh, dim: int):
    """``device_put`` with the given array dimension sharded over ALL
    mesh axes (the rest replicated) — the entry point of the serial
    drivers' ``data_mesh`` operator parallelism: XLA's SPMD partitioner
    propagates the input sharding through the Gram/projection builds and
    the per-iteration matvecs, inserting the collectives itself (the mesh
    analog of the reference's implicit BLAS threading, reference:
    src/Makevars:3-4)."""
    axes = tuple(mesh.axis_names)
    spec = [None] * arr.ndim
    spec[dim] = axes
    return jax.device_put(arr, NamedSharding(mesh, P(*spec)))
