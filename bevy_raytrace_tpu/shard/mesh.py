"""Device-mesh construction and multi-host bring-up.

The reference is single-process / single-GPU with zero inter-device
communication (SURVEY.md §2.3); here the parallelism axis is *ray/pixel
data parallelism*: the pixel wavefront shards over every device of a
(possibly multi-host) mesh, the scene (the "model") is replicated —
spheres and materials are a few KB — and gradients of replicated scene
parameters psum over the mesh (handled by shard_map's transpose; see
shard/render_sharded.py).

Mesh convention: axes ("hosts", "chips"), process-major, pixels sharded
over BOTH axes flattened (each device owns one contiguous pixel stripe).
On one host the "hosts" axis has size 1 (four cards: a (1, 4) mesh); the
same program runs unchanged across processes after
`initialize_multihost()`.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

RAY_AXES = ("hosts", "chips")


def make_mesh(devices=None, hosts: int | None = None) -> Mesh:
    """A ("hosts", "chips") mesh over the given (default: all) devices.

    `hosts` overrides the host-axis size (for virtual-device testing where
    all "hosts" are fake CPU devices); by default it is the real process
    count.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    n = devices.size
    if hosts is None:
        hosts = jax.process_count()
    if n % hosts != 0:
        raise ValueError(f"{n} devices not divisible by {hosts} hosts")
    return Mesh(devices.reshape(hosts, n // hosts), RAY_AXES)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Bring up jax.distributed for a multi-process mesh.

    Pass the coordinator address ("host:port"), process count and this
    process's id explicitly.  Safe to call once per process
    before any jax computation.  (The reference has no distributed
    runtime at all — SURVEY.md §5 'communication backend: none'.)
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
