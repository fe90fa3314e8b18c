"""Ray-sphere intersection (the reference's `intersect` stage).

Replaces `assets/shaders/intersect.wgsl:94-143`: the RTiOW half-b quadratic
per sphere, near-then-far root selection against [t_min, t_max], outward
normal `(p - c)/r`, front-face flip, material id carry, and a brute-force
scan over all spheres ("The world isn't partitioned in any way",
`intersect.wgsl:132-143` — no BVH, same here: RTiOW scenes are ~500
spheres).

This is the plain-XLA formulation, the reference every fast path is tested
against.  Instead of a per-thread loop over spheres, the whole [R, N] test
matrix is expressed through two [R, N] inner-product planes and
elementwise work:

    half_b[r,n] = (o_r - c_n) . d_r = (o_r . d_r)   - (d_r . c_n)
    c_q   [r,n] = |o_r|^2 - 2 (o_r . c_n) + (|c_n|^2 - rad_n^2)

The nearest hit is a masked min + argmin over the sphere axis; callers
bound R via RenderConfig.ray_chunk.  The fused GPU kernel
(`kernels/trace_gpu.py`) loops over spheres per ray instead.

Differentiability: `t` is smooth in (origin, dir, centers, radii) on the
interior of each hit region; the argmin/root-choice/hit masks are piecewise
constant (gradients follow the sampled discrete structure, matching finite
differences away from silhouettes — SURVEY.md §7 "hard parts").  All
`sqrt`/`div` sites use the double-where guard so masked-out lanes cannot
poison gradients with NaNs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bevy_raytrace_tpu.core.types import Hit, Ray, Scene


def intersect_scene(ray: Ray, scene: Scene, t_min: float, t_max: float) -> Hit:
    """Nearest-hit query for a ray batch against every sphere.

    ray.origin/dir: [R,3]; returns Hit with [R]-batched fields.
    Delegates to `intersect_scene_fused` (single winner-row gather);
    hot loops that also need the material parameters should call the
    fused form directly with a prebuilt `sphere_table` so the table is
    hoisted out of the bounce scan.
    """
    table = sphere_table(scene.centers, scene.radii, scene.materials,
                         scene.material_id)
    hit = intersect_scene_fused(ray, scene, t_min, t_max, table)[0]
    return hit


def gather_rows(tbl, idx):
    """tbl[idx]: the per-bounce winner-row gather.  Its transpose is XLA's
    scatter-add into the small per-sphere table (atomics on the GPU, so
    the order of the summed cotangents varies from run to run)."""
    return tbl[idx]


def sphere_table(centers, radii, materials, material_id):
    """Pack per-sphere hit+shade attributes into ONE [S, 11] table:
    [cx, cy, cz, r, albedo_rgb, kind, fuzz, ior, material_id].

    One `gather_rows` per bounce replaces seven separate winner gathers
    (centers/radius/material id + 4 material params).  Gradients flow
    back through the build (its transpose scatters into the small
    [S, ...] source arrays)."""
    return jnp.concatenate([
        centers,
        radii[:, None],
        materials.albedo[material_id],
        materials.kind[material_id].astype(jnp.float32)[:, None],
        materials.fuzz[material_id][:, None],
        materials.ior[material_id][:, None],
        # f32 round-trip is exact for ids < 2^24 (a scene with 16M
        # materials is far beyond this renderer's scale).
        material_id.astype(jnp.float32)[:, None],
    ], axis=1)


def dot_planes(d, o, c):
    """The [R, N] inner-product planes (d . c_n, o . c_n) as elementwise
    products summed over xyz: true f32 by construction, where a K=3
    matmul runs in TF32 at the GPU's default precision and is slower at
    HIGHEST (PERF.md)."""
    return (jnp.sum(d[:, None, :] * c[None, :, :], axis=-1),
            jnp.sum(o[:, None, :] * c[None, :, :], axis=-1))


def intersect_scene_fused(ray: Ray, scene: Scene, t_min: float, t_max: float,
                          table, with_second: bool = False):
    """`intersect_scene` + material gather in ONE winner-row gather.

    `table` is `sphere_table(...)` built once per render (hoisted out of
    the bounce scan).  Returns (Hit, albedo [R,3], kind [R], fuzz [R],
    ior [R], idx [R]); idx is the winner's row (meaningful where
    hit.hit).  Forward values are bit-identical to `intersect_scene` +
    `scene.gather_material`.

    `with_second=True` appends (hit2 [R] bool, albedo2 [R,3], idx2 [R]):
    the nearest hit EXCLUDING the winner sphere — the surface revealed
    when the winner's silhouette retreats, which the two-sided soft-
    silhouette boundary term uses as the background radiance estimate
    (one extra argmin over the already-computed [R,N] t matrix plus one
    gather).

    Ties: the runner-up excludes the winner by COLUMN INDEX, so a
    distinct sphere at exactly the winner's t still qualifies; the fused
    kernel's streaming runner-up has the same semantics.
    """
    o = ray.origin  # [R,3]
    d = ray.dir  # [R,3]
    c = scene.centers  # [N,3]
    rad = scene.radii  # [N]

    d_dot_c, o_dot_c = dot_planes(d, o, c)  # [R,N] each
    o_dot_d = jnp.sum(o * d, axis=-1, keepdims=True)  # [R,1]
    o2 = jnp.sum(o * o, axis=-1, keepdims=True)  # [R,1]
    a = jnp.sum(d * d, axis=-1, keepdims=True)  # [R,1] (1 for unit dirs)
    c2_minus_r2 = jnp.sum(c * c, axis=-1) - rad * rad  # [N]

    half_b = o_dot_d - d_dot_c  # [R,N]
    c_q = o2 - 2.0 * o_dot_c + c2_minus_r2[None, :]  # [R,N]

    disc = half_b * half_b - a * c_q  # [R,N]
    hit_any = disc > 0.0
    # Guarded sqrt: sqrt'(0) = inf would leak NaN into gradients of misses.
    sqrt_d = jnp.sqrt(jnp.where(hit_any, disc, 1.0))

    inv_a = 1.0 / a
    root_near = (-half_b - sqrt_d) * inv_a
    root_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit_any & (root_near > t_min) & (root_near < t_max)
    far_ok = hit_any & (root_far > t_min) & (root_far < t_max)
    # Near root wins when valid, else far root (intersect.wgsl:108-121).
    t_all = jnp.where(near_ok, root_near, jnp.where(far_ok, root_far, t_max))

    t = jnp.min(t_all, axis=-1)  # [R]
    idx = jnp.argmin(t_all, axis=-1)  # [R] piecewise-constant
    hit = t < t_max

    g = gather_rows(table, idx)  # [R, 11] — the one winner gather
    center_hit = g[:, 0:3]
    radius_hit = g[:, 3]
    albedo = g[:, 4:7]
    kind = g[:, 7].astype(jnp.int32)
    fuzz = g[:, 8]
    ior = g[:, 9]
    material = g[:, 10].astype(jnp.int32)

    # Sanitize miss lanes: with t == t_max ~ 1e20 the hit point would be
    # astronomically large and every downstream op (normals, scatter) would
    # overflow to inf/NaN — harmless in a masked forward pass but fatal to
    # gradients (0 * NaN in the where-VJP).  Dead lanes instead report the
    # ray origin and a fixed unit normal; the wavefront masks them out
    # (the reference's in-band dead-ray sentinel, `intersect.wgsl:154`).
    t_safe = jnp.where(hit, t, 0.0)
    point = o + t_safe[:, None] * d
    # Outward normal (p - c)/r — negative radius flips it (hollow glass).
    inv_r = 1.0 / jnp.where(radius_hit == 0.0, 1.0, radius_hit)
    outward = (point - center_hit) * inv_r[:, None]
    outward = jnp.where(
        hit[:, None], outward, np.array([0.0, 0.0, 1.0], np.float32)
    )
    front_face = jnp.sum(d * outward, axis=-1) < 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)

    # Silhouette margin of the hit sphere: r^2 - b_perp^2 where b_perp is
    # the perpendicular distance of the (infinite) ray line to the center.
    # Positive inside the silhouette, zero on it; its gradient w.r.t.
    # centers/radii is the lever for soft visibility gradients.
    # Normalized by r^2 so it is scale-free: edge_m2 = 1 - (b_perp/r)^2.
    oc_hit = o - center_hit
    oc2_hit = jnp.sum(oc_hit * oc_hit, axis=-1)
    ocd_hit = jnp.sum(oc_hit * d, axis=-1)
    b_perp2 = oc2_hit - (ocd_hit * ocd_hit) * inv_a[:, 0]
    r2 = jnp.maximum(radius_hit * radius_hit, 1e-12)
    edge_m2 = jnp.where(hit, 1.0 - b_perp2 / r2, 1.0)

    out = Hit(
        t=t,
        point=point,
        normal=normal,
        front_face=front_face,
        material=material,
        hit=hit,
        edge_m2=edge_m2,
    ), albedo, kind, fuzz, ior, idx
    if not with_second:
        return out
    # Runner-up: nearest hit with the winner SPHERE excluded (its far
    # surface is not "background" — shrinking the winner reveals other
    # geometry, not more of itself).
    cols = jnp.arange(t_all.shape[1], dtype=idx.dtype)[None, :]
    t2_all = jnp.where(cols == idx[:, None], t_max, t_all)
    t2 = jnp.min(t2_all, axis=-1)
    idx2 = jnp.argmin(t2_all, axis=-1)
    hit2 = t2 < t_max
    g2 = gather_rows(table, idx2)
    albedo2 = g2[:, 4:7]
    return out + ((hit2, albedo2, jnp.where(hit2, idx2, -1)),)
