"""Camera model and ray generation (the reference's `generate` stage).

Replaces `assets/shaders/generate.wgsl` + the camera uniform plumbing
(`src/ray_trace_camera.rs:14-25,43-68`).  Two constructors cover both
parametrizations:

- `Camera.look_at(...)`: the classic RTiOW thin-lens camera
  (lookfrom / lookat / vup / vfov / aperture / focus_dist).  This is the
  primary API and is differentiable w.r.t. lookfrom/lookat.
- `Camera.from_transform(...)`: the reference's parametrization — a camera
  pose matrix plus `fov` (width-referenced, McGuire & Majercik pinhole,
  `generate.wgsl:66-83`), and the thin-lens triplet `image_plane_distance`,
  `lens_focal_length`, `fstop` from which the focus plane is derived by the
  lens equation `(d*f)/(d-f)` and the aperture (circle-of-confusion) radius
  by `f/(2*fstop)` (`generate.wgsl:85-107`,
  `src/ray_trace_camera.rs:53-63`).  Unlike the reference — whose lens
  sampler is called with `lens_offset=(0,0)` and therefore degenerates to a
  pinhole (`generate.wgsl:121`) — the lens here is actually sampled
  (aperture=0 recovers the exact pinhole).

Per SURVEY.md §7 capability checklist item 1, defocus blur must be live
(BASELINE config 3 uses it).

Ray generation is a pure vectorized function of (camera, pixel ids, rng
uniforms); no per-ray state machine, no atomic work distribution
(`generate.wgsl:112` becomes a plain index map).
"""

from __future__ import annotations

import jax.numpy as jnp

from bevy_raytrace_tpu.core.types import Ray
from bevy_raytrace_tpu.pytree import pytree_dataclass
from bevy_raytrace_tpu.rng.pcg import random_in_unit_disk


def _normalize(v, axis=-1, eps=1e-12):
    n = jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True))
    return v / jnp.maximum(n, eps)


@pytree_dataclass
class Camera:
    """Thin-lens camera.

    origin [3]; u, v, w [3] right-handed orthonormal basis (w points
    *backward*: forward = -w, RTiOW convention); half_width / half_height:
    image-plane half extents at unit distance (tan of the half FOV angles);
    lens_radius: aperture radius (0 = pinhole); focus_dist: distance to the
    plane of perfect focus along -w.
    """

    origin: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    half_width: jnp.ndarray
    half_height: jnp.ndarray
    lens_radius: jnp.ndarray
    focus_dist: jnp.ndarray

    # -- constructors -------------------------------------------------------

    @staticmethod
    def look_at(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov_deg=20.0,
        aspect=16.0 / 9.0,
        aperture=0.0,
        focus_dist=None,
    ) -> "Camera":
        """RTiOW camera.  `vfov_deg` is the vertical field of view."""
        lookfrom = jnp.asarray(lookfrom, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)
        if focus_dist is None:
            focus_dist = jnp.sqrt(jnp.sum((lookfrom - lookat) ** 2))
        focus_dist = jnp.asarray(focus_dist, jnp.float32)

        theta = jnp.asarray(vfov_deg, jnp.float32) * (jnp.pi / 180.0)
        half_height = jnp.tan(theta / 2.0)
        half_width = half_height * jnp.float32(aspect)

        w = _normalize(lookfrom - lookat)
        u = _normalize(jnp.cross(vup, w))
        v = jnp.cross(w, u)
        return Camera(
            origin=lookfrom,
            u=u,
            v=v,
            w=w,
            half_width=half_width,
            half_height=half_height,
            lens_radius=jnp.asarray(aperture, jnp.float32) / 2.0,
            focus_dist=focus_dist,
        )

    @staticmethod
    def from_transform(
        transform,
        fov=1.5708,
        aspect=16.0 / 9.0,
        image_plane_distance=10.0,
        lens_focal_length=0.1,
        fstop=1.0 / 32.0,
        enable_lens=True,
    ) -> "Camera":
        """Reference parametrization (cites above).  `transform` is a 4x4
        camera-to-world matrix with -Z forward / +Y up / +X right columns
        and translation in the last column (the reference reads
        `transform.w.xyz` as the position and rotates directions by the
        matrix, `generate.wgsl:125-126`).  `fov` is *width*-referenced
        (McGuire pinhole divides by the render width, `generate.wgsl:67-77`).
        """
        transform = jnp.asarray(transform, jnp.float32)
        right = transform[:3, 0]
        up = transform[:3, 1]
        back = transform[:3, 2]  # +Z column = backward (w)
        position = transform[:3, 3]

        tan_half = jnp.tan(jnp.asarray(fov, jnp.float32) / 2.0)
        # width-referenced fov: half_width = tan(fov/2), half_height scales
        # by 1/aspect (the reference divides both axes by render_width).
        half_width = tan_half
        half_height = tan_half / jnp.float32(aspect)

        d = jnp.asarray(image_plane_distance, jnp.float32)
        f = jnp.asarray(lens_focal_length, jnp.float32)
        focus_dist = (d * f) / (d - f)  # lens equation, generate.wgsl:96-97
        coc_radius = f / (2.0 * jnp.float32(fstop))  # generate.wgsl:101
        lens_radius = jnp.where(enable_lens, coc_radius, 0.0)
        return Camera(
            origin=position,
            u=right,
            v=up,
            w=back,
            half_width=half_width,
            half_height=half_height,
            lens_radius=lens_radius,
            focus_dist=focus_dist,
        )

    # -- kernel operand packing ---------------------------------------------

    def pack(self):
        """[16] f32 kernel operand: [origin(3), u(3), v(3), w(3),
        half_width, half_height, lens_radius, focus_dist].

        The layout the fused trace kernel (`kernels/trace_gpu.py`) reads
        its camera from."""
        return jnp.concatenate([
            self.origin.reshape(-1), self.u.reshape(-1),
            self.v.reshape(-1), self.w.reshape(-1),
            self.half_width.reshape(-1), self.half_height.reshape(-1),
            self.lens_radius.reshape(-1), self.focus_dist.reshape(-1),
        ]).astype(jnp.float32)

    # -- ray generation -----------------------------------------------------

    def generate_rays(self, s, t, lens_u1, lens_u2) -> Ray:
        """Camera rays for image-plane coordinates (s, t) in [0,1)^2.

        s runs left->right, t runs bottom->top (RTiOW convention; the
        render loop flips the row index so image row 0 is the top, matching
        the reference's `-pixel.y + half_h`, `generate.wgsl:76`).
        lens_u1/lens_u2: uniforms for aperture sampling (ignored when
        lens_radius == 0 in value, still traced for shape).
        """
        # Point on the focus plane.
        px = (2.0 * s - 1.0) * self.half_width * self.focus_dist
        py = (2.0 * t - 1.0) * self.half_height * self.focus_dist
        target = (
            self.origin[None, :]
            - self.focus_dist * self.w[None, :]
            + px[:, None] * self.u[None, :]
            + py[:, None] * self.v[None, :]
        )
        # Aperture offset (defocus blur).
        du, dv = random_in_unit_disk(lens_u1, lens_u2)
        offset = self.lens_radius * (
            du[:, None] * self.u[None, :] + dv[:, None] * self.v[None, :]
        )
        origin = self.origin[None, :] + offset
        direction = _normalize(target - origin)
        return Ray(origin=origin, dir=direction)
