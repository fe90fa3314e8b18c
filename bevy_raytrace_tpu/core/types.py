"""Core SoA pytrees: rays, hits, scene, materials.

These replace the reference's hand-laid-out GPU buffers:

- `Ray`    ~ `RayGPU {origin, min, dir, max, pixel, bounces}`
             (reference `src/ray_trace_rays.rs:11-19`).  `min`/`max` live in
             RenderConfig (static), `pixel` is implicit (ray index == pixel
             index throughout a frame, as in the reference — SURVEY.md §2.2),
             and `bounces` is the scan counter.
- `Hit`    ~ `IntersectionGPU {color, point, t, normal, material, front_face}`
             (reference `src/ray_trace_intersection.rs:11-19`).  The `color`
             field (the reference's per-ray throughput accumulator) lives in
             the scan carry instead.
- `Scene`  ~ `ObjectListGPU` of `SphereGPU {center, radius, material}`
             (reference `src/sphere.rs:12-24`) as structure-of-arrays.
- `Materials` ~ `MaterialGPU {color, reflectance, fuzziness,
             index_of_refraction}` (reference
             `src/ray_trace_materials.rs:33-43`) as structure-of-arrays.

Everything is float32 / int32, batched on the leading axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from bevy_raytrace_tpu.pytree import pytree_dataclass

# Material kind encoding — same integer encoding as the reference
# (`src/ray_trace_materials.rs:144-148`): 0 = Lambertian, 1 = Metallic,
# 2 = Dielectric.
LAMBERTIAN = 0
METALLIC = 1
DIELECTRIC = 2


@pytree_dataclass
class Ray:
    """A batch of rays, SoA: origin [R,3], dir [R,3] (unit length)."""

    origin: jnp.ndarray
    dir: jnp.ndarray


@pytree_dataclass
class Hit:
    """A batch of nearest-hit records.

    t:          [R]   hit distance (t_max sentinel on miss)
    point:      [R,3] hit position
    normal:     [R,3] shading normal (faces against the incident ray)
    front_face: [R]   bool, True if the ray hit the outside surface
    material:   [R]   int32 material-table index
    hit:        [R]   bool, False = miss
    edge_m2:    [R]   silhouette margin 1 - (b_perp/r)^2 of the hit sphere
                      (b_perp = perpendicular distance of the ray line to
                      the center; > 0 inside the silhouette, 0 on it).
                      Drives the optional
                      straight-through soft-silhouette gradients
                      (RenderConfig.edge_softness); sanitized to 1 on miss.
    """

    t: jnp.ndarray
    point: jnp.ndarray
    normal: jnp.ndarray
    front_face: jnp.ndarray
    material: jnp.ndarray
    hit: jnp.ndarray
    edge_m2: jnp.ndarray


@pytree_dataclass
class Materials:
    """Material table, SoA (indexed by the per-sphere material id).

    albedo [M,3], kind [M] int32 (LAMBERTIAN/METALLIC/DIELECTRIC),
    fuzz [M], ior [M].
    """

    albedo: jnp.ndarray
    kind: jnp.ndarray
    fuzz: jnp.ndarray
    ior: jnp.ndarray

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


@pytree_dataclass
class Scene:
    """Sphere scene, SoA, plus its material table.

    centers [N,3], radii [N] (negative radius = inward-facing normal, the
    RTiOW hollow-glass trick), material_id [N] int32, materials: Materials.

    The scene is a plain pytree argument of the jitted render step, which
    is this framework's form of the reference's per-frame re-upload path that
    makes sphere transforms live-editable (`src/sphere.rs:180-197`).
    """

    centers: jnp.ndarray
    radii: jnp.ndarray
    material_id: jnp.ndarray
    materials: Materials

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    def gather_material(self, mat_idx):
        """Gather per-ray material attributes for int32 indices [R]."""
        m = self.materials
        return (
            m.albedo[mat_idx],
            m.kind[mat_idx],
            m.fuzz[mat_idx],
            m.ior[mat_idx],
        )


def make_scene(centers, radii, material_id, albedo, kind, fuzz, ior) -> Scene:
    """Build a Scene from array-likes with dtype normalization."""
    return Scene(
        centers=jnp.asarray(centers, jnp.float32).reshape(-1, 3),
        radii=jnp.asarray(radii, jnp.float32).reshape(-1),
        material_id=jnp.asarray(material_id, jnp.int32).reshape(-1),
        materials=Materials(
            albedo=jnp.asarray(albedo, jnp.float32).reshape(-1, 3),
            kind=jnp.asarray(kind, jnp.int32).reshape(-1),
            fuzz=jnp.asarray(fuzz, jnp.float32).reshape(-1),
            ior=jnp.asarray(ior, jnp.float32).reshape(-1),
        ),
    )
