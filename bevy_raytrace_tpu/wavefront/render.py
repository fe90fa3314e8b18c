"""The wavefront render engine — one pure function per frame.

This module is the plain-XLA form of the reference's entire frame
machinery: the render-graph node that records `clear -> generate -> 3x
(prepass -> intersect -> shade) -> collect` into a compute pass
(`src/ray_trace_node.rs:204-220`) plus the six WGSL kernels.  Stage map:

  clear    (`clear.wgsl:74-87`)    -> the scan-carry init (throughput = 1,
                                      radiance = 0); no framebuffer clear is
                                      needed because the frame is a value.
  prepass  (`prepass.wgsl:55-63`)  -> gone: no atomic counters to reset; the
                                      work distribution is an index map.
  generate (`generate.wgsl`)       -> Camera.generate_rays over pixel ids.
  intersect(`intersect.wgsl`)      -> core.geometry.intersect_scene.
  shade    (`shade.wgsl`)          -> core.materials.scatter + sky.
  collect  (`collect.wgsl:99-126`) -> mean over the sample axis (the
                                      multi-sample average the reference
                                      scaffolds but never enables).

The bounce loop is a fixed-depth `lax.scan` whose carry is
(ray, throughput, radiance, alive) — exactly the per-ray state the
reference threads through its ray/intersection buffers (SURVEY.md §3.4).
`jax.checkpoint` on the scan body rematerializes per-bounce state in the
backward pass instead of storing depth x spp intermediates (SURVEY.md §7
"hard parts": memory at scale).

With `record=True` the scan also emits each bounce's winner sphere index
(-1 = miss or dead path), and the runner-up when `edge_softness > 0`: the
plain-XLA recorder whose int16 residuals `inverse.fast_grad` replays, and
the reference the fused kernel's residuals are tested against.

Wavefront shape invariants (mirroring the reference, SURVEY.md §2.2): the
queue is dense and statically shaped; dead lanes are masked, never
compacted; ray index == pixel index, so `collect` needs no scatter.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.core.camera import Camera
from bevy_raytrace_tpu.core.geometry import (
    intersect_scene_fused,
    sphere_table,
)
from bevy_raytrace_tpu.core.materials import scatter, sky_color
from bevy_raytrace_tpu.core.types import Ray, Scene
from bevy_raytrace_tpu.rng.pcg import uniform4

# Dedicated RNG stream for camera-ray generation (pixel jitter + lens
# sampling); bounce events use stream == bounce index (0..max_depth-1).
CAMERA_STREAM = 0x9E3779B9
# Frame decorrelation: the frame index is folded into the seed counter the
# way the reference folds `frame` into its hash input
# (`shade.wgsl:216-218`), but per-draw-site rather than per-frame-global.
FRAME_MIX = 0x85EBCA6B


def frame_seed(config: RenderConfig, frame):
    """The RNG seed counter of `frame`: a host uint32 when `frame` is a
    python int, traced when it is a device value.  Wraps mod 2**32."""
    with np.errstate(over="ignore"):  # uint32 wrap is intended
        return np.uint32(config.seed) + np.uint32(FRAME_MIX) * (
            np.uint32(frame) if isinstance(frame, int)
            else frame.astype(jnp.uint32))


def _bounce_step(scene: Scene, config: RenderConfig, pixel_ids, sample_ids,
                 seed, record: bool = False):
    """Returns the scan body for one (intersect -> shade) round.  With
    `record`, its per-bounce output is the int16 winner index (and
    runner-up when edge_softness > 0), -1 for a miss or a dead path."""
    # One packed winner gather per bounce instead of seven (centers,
    # radius, material id + 4 material params): the table is built here,
    # outside the scan.  Values are bit-identical.
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)

    with_second = config.edge_softness > 0.0

    def body(carry, bounce_idx):
        ray, throughput, radiance, alive = carry
        out = intersect_scene_fused(
            ray, scene, config.t_min, config.t_max, table,
            with_second=with_second)
        hit, albedo, kind, fuzz, ior, idx = out[:6]
        u = uniform4(pixel_ids, sample_ids, bounce_idx, seed)
        new_dir, attenuation, scatter_ok = scatter(
            ray.dir, hit.normal, hit.front_face, albedo, kind, fuzz, ior, u
        )

        miss = ~hit.hit
        sky = sky_color(ray.dir)
        add_sky = (alive & miss)[:, None]
        radiance = radiance + jnp.where(add_sky, throughput * sky, 0.0)

        scattered = alive & hit.hit
        attenuation_eff = attenuation
        if config.edge_softness > 0.0:
            # Straight-through soft silhouettes: st == 1.0 exactly in value
            # (s - stop_grad(s) is exactly 0), so the image is bit-identical
            # to the hard render; only gradients gain the boundary term
            # ds * (L_path - L_bg).  TWO-SIDED: L_bg is
            # the radiance estimate BEHIND the edge — the runner-up hit's
            # one-bounce shade (albedo2 * sky) when the edge occludes
            # geometry, the sky itself otherwise.  The one-sided
            # sky-completion form measurably flipped the gradient sign
            # against occluders (tests/test_silhouette.py history).
            hit2, albedo2, _ = out[6]
            s_soft = jax.nn.sigmoid(hit.edge_m2 / config.edge_softness)
            st = 1.0 + (s_soft - jax.lax.stop_gradient(s_soft))
            attenuation_eff = attenuation * st[:, None]
            sky_bg = jnp.where(hit2[:, None],
                               jax.lax.stop_gradient(albedo2) * sky, sky)
            radiance = radiance + jnp.where(
                scattered[:, None],
                (1.0 - st)[:, None] * throughput * sky_bg, 0.0
            )
        throughput = jnp.where(
            scattered[:, None], throughput * attenuation_eff, throughput
        )
        alive_next = scattered & scatter_ok

        # Dead lanes keep their old ray (full-width wavefront, masked
        # lanes — no compaction, SURVEY.md §2.2).  Re-tracing a dead lane
        # is wasted-but-masked work, and keeps every value finite for the
        # backward pass.
        keep = alive_next[:, None]
        ray = Ray(
            origin=jnp.where(keep, hit.point, ray.origin),
            dir=jnp.where(keep, new_dir, ray.dir),
        )
        ys = None
        if record:
            rec = jnp.where(scattered, idx, -1).astype(jnp.int16)
            ys = (rec,)
            if with_second:
                rec2 = jnp.where(scattered, out[6][2], -1)
                ys += (rec2.astype(jnp.int16),)
        return (ray, throughput, radiance, alive_next), ys

    return body


def trace_paths(scene, camera, config, pixel_ids, sample_ids, seed,
                record: bool = False):
    """Trace one path per (pixel_id, sample_id) pair; returns radiance [K,3]
    (and, with `record`, the per-bounce residuals, each int16
    [max_depth, K]).

    Paths that are still alive after max_depth bounces contribute black
    (RTiOW depth-exhaustion; the reference kills at bounces==2 with black,
    `shade.wgsl:236-238`).
    """
    k = pixel_ids.shape[0]
    cu1, cu2, cu3, cu4 = uniform4(pixel_ids, sample_ids, CAMERA_STREAM, seed)

    x = (pixel_ids % config.width).astype(jnp.float32)
    y = (pixel_ids // config.width).astype(jnp.float32)
    # Image row 0 is the top (reference flips y, `generate.wgsl:76`);
    # jittered sub-pixel sampling (RTiOW antialiasing).
    s = (x + cu1) / config.width
    t = 1.0 - (y + cu2) / config.height
    ray = camera.generate_rays(s, t, cu3, cu4)

    throughput = jnp.ones((k, 3), jnp.float32)
    radiance = jnp.zeros((k, 3), jnp.float32)
    alive = jnp.ones((k,), bool)

    body = jax.checkpoint(
        _bounce_step(scene, config, pixel_ids, sample_ids, seed, record)
    )
    (_, _, radiance, _), recs = jax.lax.scan(
        body,
        (ray, throughput, radiance, alive),
        np.arange(config.max_depth, dtype=np.uint32),
    )
    return (radiance, *recs) if record else radiance


def render_pixel_range(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    pixel_start,
    num_local: int,
    frame=0,
    record: bool = False,
):
    """Render `num_local` consecutive pixels starting at absolute pixel id
    `pixel_start` -> flat [num_local, 3] framebuffer slice.

    `pixel_start` may be a traced value (a mesh `axis_index` offset inside
    shard_map): RNG counters key on *absolute* pixel ids, so any
    partitioning of the wavefront produces bit-identical pixels
    (SURVEY.md §7: same RNG stream regardless of mesh shape).

    `record=True` returns (fb, res[, res2]): the int16 per-bounce winner
    residuals [spp, max_depth, num_local] (see `trace_paths`).
    """
    seed = frame_seed(config, frame)

    spp_chunk = max(config.spp_chunk, 1)
    n_sample_chunks = config.samples_per_pixel // spp_chunk
    ray_chunk = config.ray_chunk or num_local
    if num_local % ray_chunk != 0:
        # A non-dividing ray_chunk used to silently fall back to the full
        # width — materializing the whole [rays, spheres] workspace the
        # chunk existed to bound.  Use the divisor
        # with the closest work ratio to the request (rounding
        # only DOWN degenerated to ray_chunk=1 for awkward shard sizes —
        # e.g. a prime num_local — a scan of num_local single-ray steps,
        # a far worse cliff than a modestly bigger workspace).
        import warnings

        requested = ray_chunk
        divisors = [d for d in range(1, num_local + 1)
                    if num_local % d == 0]
        ray_chunk = min(divisors,
                        key=lambda d: abs(np.log(d / requested)))
        over = ("; NOTE: larger than requested — the [rays, spheres] "
                "workspace bound is exceeded by this factor"
                if ray_chunk > requested else "")
        warnings.warn(
            f"ray_chunk={requested} does not divide the local pixel count "
            f"{num_local}; using the closest divisor {ray_chunk}{over}",
            stacklevel=2)
    n_ray_chunks = num_local // ray_chunk

    # Pixel/sample id plumbing stays numpy when pixel_start is static: it
    # then embeds into the lowered program without a device round-trip.
    local_ids = np.arange(num_local, dtype=np.uint32)
    if isinstance(pixel_start, (int, np.integer)):
        pixel_ids = local_ids + np.uint32(pixel_start)
    else:
        pixel_ids = pixel_start.astype(jnp.uint32) + local_ids
    pixel_chunks = pixel_ids.reshape(n_ray_chunks, ray_chunk)
    sample_offsets = np.repeat(
        np.arange(spp_chunk, dtype=np.uint32), ray_chunk
    )  # [spp_chunk * ray_chunk]

    def render_sample_chunk(sample_base):
        """Radiance sum over one chunk of spp_chunk samples, all pixels."""

        def per_ray_chunk(pids):
            # Flatten (pixel, sample) pairs into one wavefront batch.
            xp = np if isinstance(pids, np.ndarray) else jnp
            pids_tiled = xp.tile(pids, spp_chunk)
            sids = sample_base + sample_offsets
            out = trace_paths(scene, camera, config, pids_tiled, sids, seed,
                              record)
            rad, recs = (out[0], out[1:]) if record else (out, ())
            recs = tuple(r.reshape(-1, spp_chunk, ray_chunk) for r in recs)
            return rad.reshape(spp_chunk, ray_chunk, 3).sum(axis=0), recs

        if n_ray_chunks == 1:
            fb, recs = per_ray_chunk(pixel_chunks[0])
            return fb, tuple(r[None] for r in recs)
        fb, recs = jax.lax.map(per_ray_chunk, pixel_chunks)
        return fb.reshape(num_local, 3), recs

    def spp_body(fb_sum, sample_base):
        fb, recs = render_sample_chunk(sample_base)
        return fb_sum + fb, recs

    if n_sample_chunks == 1:
        fb_sum, recs = render_sample_chunk(np.uint32(0))
        recs = tuple(r[None] for r in recs)
    else:
        fb_sum, recs = jax.lax.scan(
            spp_body,
            jnp.zeros((num_local, 3), jnp.float32),
            np.arange(n_sample_chunks, dtype=np.uint32) * np.uint32(spp_chunk),
        )

    fb = fb_sum / np.float32(config.samples_per_pixel)
    if not record:
        return fb
    # [sample chunk, ray chunk, depth, sample, ray] -> [spp, depth, pixel]
    return (fb, *(
        r.transpose(0, 3, 2, 1, 4).reshape(
            config.samples_per_pixel, config.max_depth, num_local)
        for r in recs))


def render_record(scene: Scene, camera: Camera, config: RenderConfig,
                  frame=0):
    """`render` plus its residuals: (image [H, W, 3], res[, res2]), each
    residual int16 [spp, max_depth, H*W] — the plain-XLA form of the fused
    kernel's `render_pallas(..., with_residuals=True)`; `res2` (the
    runner-up) is recorded when `config.edge_softness > 0`."""
    fb, *res = render_pixel_range(scene, camera, config, 0,
                                  config.num_pixels, frame, record=True)
    return (fb.reshape(config.height, config.width, 3), *res)


def render(scene: Scene, camera: Camera, config: RenderConfig, frame=0):
    """Render one frame -> linear float32 image [height, width, 3].

    `scene` and `camera` are traced pytree arguments: editing them between
    calls costs nothing (unlike the reference's per-frame
    re-upload path, `src/sphere.rs:180-197`, `src/ray_trace_camera.rs:43-68`).
    `frame` decorrelates sampling across frames.  Jit with config static:
    `jax.jit(render, static_argnums=2)` or use `make_renderer`.
    """
    fb = render_pixel_range(scene, camera, config, 0, config.num_pixels, frame)
    return fb.reshape(config.height, config.width, 3)


def make_renderer(config: RenderConfig):
    """A jitted `render(scene, camera, frame=0)` specialized to `config`.

    For a stateful session (auto frame counter, warmup, backend choice)
    use `wavefront.engine.Renderer`.
    """

    @jax.jit
    def step(scene, camera, frame=0):
        return render(scene, camera, config, frame)

    return step
