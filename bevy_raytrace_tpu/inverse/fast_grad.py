"""Fast differentiable rendering: recorded forward + replay backward.

The XLA wavefront (`wavefront/render.py`) is differentiable but pays the
dense [rays, spheres] intersection sweep in BOTH directions.  This module
removes the sweep from the backward pass entirely:

  forward   — a recording render: alongside the image it records, per
              (sample, bounce, pixel), the winning sphere index (-1 for
              miss) — a compact int16 checkpoint of every discrete choice
              the sampled paths made.  `forward="pallas"` records with
              the fused GPU kernel (`kernels/trace_gpu.py`);
              `forward="xla"` with the XLA wavefront's recorder
              (`wavefront.render_record`), the plain reference.

  backward  — `replay_pixel_range` re-traces every path in plain
              differentiable jnp WITHOUT any nearest-hit search: the
              winner is read from the residual, its exact `t` recomputed
              in closed form, and the same PCG4D counters replay the same
              random numbers.  `jax.vjp` of the replay then yields
              scene/camera cotangents.

Gradient semantics follow the same straight-through policy as the XLA
path (discrete events — argmin winner, hit/miss, root choice, material
branch, Schlick Bernoulli — are frozen at their sampled values; continuous
quantities differentiate through), including the `edge_softness` soft-
silhouette boundary term, whose background estimate comes from the
recorded runner-up.  Agreement with jax.grad of the XLA wavefront is
exact (to f32) on well-conditioned scenes; near-tangency paths — whose
d(t)/d(theta) ~ 1/sqrt(disc) diverges — may resolve their discrete flips
differently between backends, so on grazing-heavy scenes the two
estimators agree on the bulk of components while outlier tails differ
(both are legitimate; tests/test_fast_grad.py quantifies).

This mirrors the reference's wavefront state handoff (`ray_trace_rays.rs`
ray buffer carrying per-bounce state between dispatch rounds,
`src/ray_trace_node.rs:213-217`) — but as a reverse-mode checkpoint rather
than a live queue.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.core.geometry import gather_rows, sphere_table
from bevy_raytrace_tpu.core.materials import scatter, sky_color
from bevy_raytrace_tpu.core.types import Ray
from bevy_raytrace_tpu.rng.pcg import uniform4
from bevy_raytrace_tpu.wavefront.render import (
    CAMERA_STREAM,
    frame_seed,
    render_pixel_range,
)


_UNIT_Z = np.array([0.0, 0.0, 1.0], np.float32)


def replay_paths(camera, config: RenderConfig, pixel_ids, sample_ids,
                 seed, res_db, tbl, remat: bool = True, res2_db=None):
    """Differentiable re-trace of recorded paths -> radiance [K, 3].

    Scene cotangents flow exclusively through `tbl` (built by the
    caller from the scene; there is no separate scene argument).

    res_db: int16 [max_depth, K] winner sphere index per bounce (-1 miss);
    indices refer to rows of `tbl` (`core.geometry.sphere_table`).  RNG
    counters are identical to the recording forward's, so the replayed
    path IS the sampled path.

    res2_db: runner-up sphere index per bounce (-1 = none), required when
    config.edge_softness > 0 — the TWO-SIDED boundary term's background
    estimate gathers the occluding edge's revealed surface from it.
    """
    t_min = np.float32(config.t_min)
    k = pixel_ids.shape[0]
    if config.edge_softness > 0.0 and res2_db is None:
        raise ValueError(
            "edge_softness > 0 requires runner-up residuals (res2) — "
            "record the forward's runner-up as well")
    cu1, cu2, cu3, cu4 = uniform4(pixel_ids, sample_ids, CAMERA_STREAM, seed)
    x = (pixel_ids % config.width).astype(jnp.float32)
    y = (pixel_ids // config.width).astype(jnp.float32)
    s = (x + cu1) / config.width
    t = 1.0 - (y + cu2) / config.height
    ray = camera.generate_rays(s, t, cu3, cu4)

    throughput = jnp.ones((k, 3), jnp.float32)
    radiance = jnp.zeros((k, 3), jnp.float32)
    alive = jnp.ones((k,), bool)

    def body(carry, xs):
        if res2_db is not None:
            bounce_idx, sidx, sidx2 = xs
            sidx2 = sidx2.astype(jnp.int32)
        else:
            bounce_idx, sidx = xs
        sidx = sidx.astype(jnp.int32)
        ray, throughput, radiance, alive = carry
        o, d = ray.origin, ray.dir
        hit = (sidx >= 0) & alive
        g = gather_rows(tbl, jnp.maximum(sidx, 0))  # [K, 11], one gather
        c = g[:, 0:3]
        r = g[:, 3]

        # Exact nearest t of the recorded winner, centered quadratic.
        oc = o - c
        hb = jnp.sum(oc * d, axis=-1)
        oc2 = jnp.sum(oc * oc, axis=-1)
        cq = oc2 - r * r
        disc = hb * hb - cq
        # Double-where sqrt guard, TWO hazards (not just masked misses):
        # the forward recorded `hit` under its own fma contraction, so a
        # tangency-grazing winner can REPLAY with disc <= 0 here even
        # though the forward saw disc > 0.  sqrt'(0)=inf would then NaN
        # every gradient.  Flipped lanes
        # take value sq=0 (t = -hb, the tangent point) with zero gradient
        # through sq — the physically unbounded tangency derivative is
        # straight-through dropped, matching the XLA path's policy of
        # piecewise-constant discrete structure.
        pos = hit & (disc > 0.0)
        sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
        rn = -hb - sq
        rf = sq - hb
        t_hit = jnp.where(rn > t_min, rn, rf)
        t_safe = jnp.where(hit, t_hit, 0.0)
        point = o + t_safe[:, None] * d
        inv_r = 1.0 / jnp.where(r == 0.0, 1.0, r)
        outward = (point - c) * inv_r[:, None]
        outward = jnp.where(hit[:, None], outward, _UNIT_Z)
        front_face = jnp.sum(d * outward, axis=-1) < 0.0
        normal = jnp.where(front_face[:, None], outward, -outward)

        albedo = g[:, 4:7]
        kind = g[:, 7].astype(jnp.int32)
        fuzz = g[:, 8]
        ior = g[:, 9]
        u = uniform4(pixel_ids, sample_ids, bounce_idx, seed)
        new_dir, attenuation, scatter_ok = scatter(
            d, normal, front_face, albedo, kind, fuzz, ior, u)

        miss = ~hit
        sky = sky_color(d)
        add_sky = (alive & miss)[:, None]
        radiance = radiance + jnp.where(add_sky, throughput * sky, 0.0)

        scattered = alive & hit
        attenuation_eff = attenuation
        if config.edge_softness > 0.0:
            # Same TWO-SIDED soft-silhouette straight-through as the XLA
            # path (wavefront/render.py): value untouched, gradients gain
            # the boundary term ds * (L_path - L_bg) with L_bg from the
            # recorded runner-up hit (albedo2 * sky) or the sky itself.
            b_perp2 = oc2 - hb * hb
            r2 = jnp.maximum(r * r, 1e-12)
            edge_m2 = jnp.where(hit, 1.0 - b_perp2 / r2, 1.0)
            s_soft = jax.nn.sigmoid(edge_m2 / config.edge_softness)
            st = 1.0 + (s_soft - jax.lax.stop_gradient(s_soft))
            attenuation_eff = attenuation * st[:, None]
            hit2 = sidx2 >= 0
            g2 = jax.lax.stop_gradient(
                gather_rows(tbl, jnp.maximum(sidx2, 0)))
            sky_bg = jnp.where(hit2[:, None], g2[:, 4:7] * sky, sky)
            radiance = radiance + jnp.where(
                scattered[:, None],
                (1.0 - st)[:, None] * throughput * sky_bg, 0.0)
        throughput = jnp.where(
            scattered[:, None], throughput * attenuation_eff, throughput)
        alive_next = scattered & scatter_ok
        keep = alive_next[:, None]
        ray = Ray(origin=jnp.where(keep, point, o),
                  dir=jnp.where(keep, new_dir, d))
        return (ray, throughput, radiance, alive_next), None

    xs = (np.arange(config.max_depth, dtype=np.uint32), res_db)
    if res2_db is not None:
        xs = xs + (res2_db,)
    (_, _, radiance, _), _ = jax.lax.scan(
        jax.checkpoint(body) if remat else body,
        (ray, throughput, radiance, alive),
        xs,
    )
    return radiance


# Above this many stored bounce-state bytes the replay is rematerialized
# (checkpointed) instead of stored.  ~40 f32 of live state per path per
# bounce.
_REMAT_BYTES = 4 << 30


def replay_pixel_range(tbl, camera, config: RenderConfig, res, pixel_start,
                       num_local: int, frame=0, remat=None, res2=None):
    """Differentiable radiance of recorded paths -> flat [num_local, 3].

    res: int16 [spp, max_depth, P] with P >= num_local (padding is sliced
    off), stripe-local: column i is absolute pixel `pixel_start + i`
    (`pixel_start` may be traced, e.g. a mesh rank times the stripe).
    `tbl` is `core.geometry.sphere_table` of the scene; cotangents of the
    scene flow through it.  `remat`: None = checkpoint each sample's
    replay when storing every sample's bounce state would exceed
    _REMAT_BYTES, and also its bounce scan when one sample's would;
    True/False forces both.  `res2`: runner-up residuals, required when
    config.edge_softness > 0 (two-sided boundary term).
    """
    per_sample_bytes = config.max_depth * num_local * 40 * 4
    if remat is None:
        remat_sample = (config.samples_per_pixel * per_sample_bytes
                        > _REMAT_BYTES)
        remat_bounce = per_sample_bytes > _REMAT_BYTES
    else:
        remat_sample = remat_bounce = remat
    seed = frame_seed(config, frame)
    local_ids = np.arange(num_local, dtype=np.uint32)
    if isinstance(pixel_start, (int, np.integer)):
        pixel_ids = local_ids + np.uint32(pixel_start)
    else:
        pixel_ids = pixel_start.astype(jnp.uint32) + local_ids
    xs = (np.arange(config.samples_per_pixel, dtype=np.uint32),
          res[:, :, :num_local])
    if res2 is not None:
        xs = xs + (res2[:, :, :num_local],)

    def per_sample(fb_sum, xs):
        s_id, res_s = xs[0], xs[1]
        res2_s = xs[2] if len(xs) > 2 else None
        rad = replay_paths(camera, config, pixel_ids, s_id, seed, res_s, tbl,
                           remat=remat_bounce, res2_db=res2_s)
        return fb_sum + rad, None

    fb, _ = jax.lax.scan(
        jax.checkpoint(per_sample) if remat_sample else per_sample,
        jnp.zeros((num_local, 3), jnp.float32), xs)
    return fb / np.float32(config.samples_per_pixel)


def scene_table(scene):
    """The replay's [S, 11] sphere table of `scene`."""
    return sphere_table(scene.centers, scene.radii, scene.materials,
                        scene.material_id)


def replay_image(scene, camera, config: RenderConfig, res, frame=0,
                 remat=None, res2=None):
    """Differentiable image from recorded residuals -> [H, W, 3]
    (`replay_pixel_range` over the whole frame)."""
    fb = replay_pixel_range(scene_table(scene), camera, config, res, 0,
                            config.num_pixels, frame, remat, res2)
    return fb.reshape(config.height, config.width, 3)


def zero_cotangent(x):
    arr = jnp.asarray(x)
    if jnp.issubdtype(arr.dtype, jnp.floating):
        return jnp.zeros_like(arr)
    return np.zeros(np.shape(x), dtype=jax.dtypes.float0)


def recorder(config: RenderConfig, forward: str = "pallas",
             interpret: bool = False):
    """`record(scene, camera, frame, pixel_base, num_local) -> (flat
    [num_local, 3] stripe, res[, res2])` for the chosen forward:
    "pallas" (the fused GPU kernel) or "xla" (the wavefront recorder)."""
    if forward not in ("pallas", "xla"):
        raise ValueError(
            f"unknown forward {forward!r}; expected 'pallas' or 'xla'")
    record_second = config.edge_softness > 0.0
    if forward == "xla":
        def record(scene, camera, frame, pixel_base, num_local):
            return render_pixel_range(scene, camera, config, pixel_base,
                                      num_local, frame, record=True)
        return record
    from bevy_raytrace_tpu.kernels.trace_gpu import render_pallas

    def record(scene, camera, frame, pixel_base, num_local):
        return render_pallas(scene, camera, config, frame,
                             interpret=interpret, with_residuals=True,
                             record_second=record_second,
                             pixel_base=pixel_base, num_local=num_local)
    return record


def make_fast_renderer(config: RenderConfig, forward: str = "pallas",
                       interpret: bool = False, remat=None):
    """A differentiable `render(scene, camera, frame) -> image` whose
    forward is a recording render and whose backward replays the
    recorded paths (no sphere sweep).

    Use under `jax.jit` / `jax.grad` exactly like `wavefront.render`
    specialized to `config`.  Gradients match the XLA path's
    (tests/test_fast_grad.py): exactly on well-conditioned scenes; on
    grazing-heavy scenes the bulk of components agrees while the
    near-tangency outlier tail differs between backends (both are
    legitimate straight-through estimates).

    `forward`: "pallas" records with the fused GPU kernel, "xla" with the
    wavefront recorder (see `recorder`).  `interpret` runs the kernel in
    the Pallas interpreter.  `remat`: see `replay_pixel_range`.
    """
    record = recorder(config, forward, interpret)
    num_pixels = config.num_pixels
    shape = (config.height, config.width, 3)

    @jax.custom_vjp
    def render_fast(scene, camera, frame):
        return record(scene, camera, frame, 0, num_pixels)[0].reshape(shape)

    def fwd(scene, camera, frame):
        img, res, *rest = record(scene, camera, frame, 0, num_pixels)
        res2 = rest[0] if rest else None
        return img.reshape(shape), (scene, camera, frame, res, res2)

    def bwd(saved, g):
        scene, camera, frame, res, res2 = saved
        _, vjp = jax.vjp(
            lambda sc, cam: replay_image(sc, cam, config, res, frame,
                                         remat=remat, res2=res2),
            scene, camera)
        d_scene, d_camera = vjp(g)
        return d_scene, d_camera, zero_cotangent(frame)

    render_fast.defvjp(fwd, bwd)
    return render_fast
