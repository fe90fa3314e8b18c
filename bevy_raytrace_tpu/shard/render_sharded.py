"""Multi-device wavefront rendering via shard_map.

The reference sizes one GPU dispatch to the whole ray queue
(`src/ray_trace_node.rs:37-38`); here the wavefront shards across a device
mesh: each device renders one contiguous stripe of pixels (ray index ==
pixel index is preserved *globally*, so "collect" still needs no scatter —
the sharded framebuffer IS the image).

Why shard_map (not bare GSPMD annotations): the per-device pixel offset
must feed the RNG counters, and `jax.lax.axis_index` inside shard_map
gives it exactly; every pixel then gets the same samples as in the
single-device render, so resharding is bit-exact (tested).

Differentiation: scene/camera enter replicated (spec P()); shard_map's
transpose inserts the psum over the mesh for their cotangents — the
gradient all-reduce, placed by the partitioner so XLA's scheduler can
overlap it with the backward bounce sweep.
"""

from __future__ import annotations

import functools

import jax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.shard.mesh import RAY_AXES
from bevy_raytrace_tpu.wavefront.render import render_pixel_range


def mesh_rank():
    """Flattened device rank inside shard_map (hosts-major)."""
    return (jax.lax.axis_index(RAY_AXES[0]) * jax.lax.axis_size(RAY_AXES[1])
            + jax.lax.axis_index(RAY_AXES[1]))


def render_sharded(scene, camera, config: RenderConfig, mesh: Mesh, frame=0,
                   backend: str = "xla", interpret: bool = False):
    """Render with pixels sharded over every device of `mesh`.

    `backend`: "xla" renders each stripe with the wavefront, "pallas" with
    the fused GPU kernel's stripe mode (`interpret` runs it in the Pallas
    interpreter).  Either way the stripes compose into the single-device
    image of that backend.

    Returns the [H, W, 3] image, row-sharded over the mesh (host-local
    shards stay on their devices; materialize with np.asarray / jax.device_get
    only when writing the image out).
    """
    if backend not in ("xla", "pallas"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'xla' or 'pallas'")
    n_devices = mesh.devices.size
    num_pixels = config.num_pixels
    if num_pixels % n_devices != 0:
        raise ValueError(
            f"num_pixels={num_pixels} must divide over {n_devices} devices"
        )
    local = num_pixels // n_devices

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(RAY_AXES),
        check_vma=False,  # scene/camera cotangents still psum (tested)
    )
    def shard_fn(scene, camera):
        start = (mesh_rank() * local).astype("uint32")
        if backend == "pallas":
            from bevy_raytrace_tpu.kernels.trace_gpu import render_pallas

            return render_pallas(scene, camera, config, frame,
                                 interpret=interpret, pixel_base=start,
                                 num_local=local)
        return render_pixel_range(scene, camera, config, start, local, frame)

    fb = shard_fn(scene, camera)  # [num_pixels, 3], sharded
    return fb.reshape(config.height, config.width, 3)


def make_sharded_renderer(config: RenderConfig, mesh: Mesh):
    """Jitted sharded `render(scene, camera, frame)` with replicated inputs."""
    replicated = NamedSharding(mesh, P())

    @functools.partial(jax.jit, in_shardings=(replicated, replicated, None))
    def step(scene, camera, frame):
        return render_sharded(scene, camera, config, mesh, frame)

    return step
