"""Sharded fast gradients: record + replay per device stripe, psum'd
cotangents.

Puts the whole fast gradient path (`inverse/fast_grad.py`) under
`shard_map`:

  forward   — each device records its contiguous pixel stripe (the fused
              kernel's stripe mode, or the wavefront recorder): residuals
              stay stripe-sharded in device memory between forward and
              backward;
  backward  — each device replays its own residual stripe against its
              stripe of the image cotangent, then `psum`s the [S, 11]
              table cotangent and the camera cotangent over the mesh —
              the one small all-reduce of the gradient step.

The custom_vjp sits OUTSIDE the shard_maps, so forward and backward are
each one shard_map: the structure a multi-host training step compiles.

RNG keys on ABSOLUTE pixel ids, so the sharded image AND its gradients
match the single-device fast path at any mesh shape
(tests/test_shard_grad.py: image bit-exact, cotangents to f32 psum-order
tolerance).

The reference has no gradients and no multi-GPU path at all; its closest
analog is the single dispatch sized to the whole ray queue
(`src/ray_trace_node.rs:37-38`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.inverse.fast_grad import (
    recorder,
    replay_pixel_range,
    scene_table,
    zero_cotangent,
)
from bevy_raytrace_tpu.shard.render_sharded import RAY_AXES, mesh_rank


def make_fast_renderer_sharded(config: RenderConfig, mesh: Mesh,
                               forward: str = "pallas",
                               interpret: bool = False):
    """A differentiable sharded `render(scene, camera, frame) -> [H, W, 3]`
    whose forward records per device stripe and whose backward replays
    per stripe (`forward`/`interpret` as in `make_fast_renderer`).

    Use under jax.jit / jax.grad like `make_fast_renderer`; the image
    comes back row-sharded, scene/camera cotangents replicated (psum'd).
    """
    n_devices = mesh.devices.size
    num_pixels = config.num_pixels
    if num_pixels % n_devices != 0:
        raise ValueError(
            f"num_pixels={num_pixels} must divide over {n_devices} devices")
    local = num_pixels // n_devices
    record = recorder(config, forward, interpret)
    record_second = config.edge_softness > 0.0
    shape = (config.height, config.width, 3)
    # Residuals stay sharded on the stripe (= pixel) axis end to end.
    res_spec = P(None, None, RAY_AXES)
    smap = functools.partial(shard_map, mesh=mesh, check_vma=False)

    def _record(scene, camera, frame):
        out_specs = (P(RAY_AXES), res_spec)
        if record_second:
            out_specs = out_specs + (res_spec,)

        @functools.partial(smap, in_specs=(P(), P()), out_specs=out_specs)
        def fwd_shard(scene, camera):
            base = (mesh_rank() * local).astype(jnp.uint32)
            return tuple(record(scene, camera, frame, base, local))

        return fwd_shard(scene, camera)

    @jax.custom_vjp
    def render_fast(scene, camera, frame):
        return _record(scene, camera, frame)[0].reshape(shape)

    def fwd(scene, camera, frame):
        img, res, *rest = _record(scene, camera, frame)
        res2 = rest[0] if rest else None
        return img.reshape(shape), (scene, camera, frame, res, res2)

    def bwd(saved, g):
        scene, camera, frame, res, res2 = saved
        tbl, tbl_vjp = jax.vjp(scene_table, scene)
        in_specs = (P(), P(), res_spec, P(RAY_AXES))
        args = [tbl, camera, res, g.reshape(num_pixels, 3)]
        if res2 is not None:
            in_specs = in_specs + (res_spec,)
            args.append(res2)

        @functools.partial(smap, in_specs=in_specs, out_specs=(P(), P()))
        def bwd_shard(tbl, camera, res, g_stripe, res2=None):
            base = (mesh_rank() * local).astype(jnp.uint32)
            _, vjp = jax.vjp(
                lambda t, cam: replay_pixel_range(
                    t, cam, config, res, base, local, frame, res2=res2),
                tbl, camera)
            d_tbl, d_cam = vjp(g_stripe)
            # The gradient all-reduce: [S, 11] + the camera's 16 scalars.
            return (jax.lax.psum(d_tbl, RAY_AXES),
                    jax.lax.psum(d_cam, RAY_AXES))

        d_tbl, d_cam = bwd_shard(*args)
        (d_scene,) = tbl_vjp(d_tbl)
        return d_scene, d_cam, zero_cotangent(frame)

    render_fast.defvjp(fwd, bwd)
    return render_fast
