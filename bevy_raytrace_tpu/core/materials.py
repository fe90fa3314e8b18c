"""Material scatter models + sky (the reference's `shade` stage).

Replaces `assets/shaders/shade.wgsl`:

- Lambertian scatter (`shade.wgsl:118-130`) — corrected per SURVEY.md: the
  new direction is `normal + random_unit_vector` with the RTiOW near-zero
  degeneracy guard, not the reference's positive-octant-biased
  `normalize(seed)`.
- Metallic scatter (`shade.wgsl:132-146`): mirror reflect + fuzz * point in
  unit sphere; additionally implements RTiOW's absorb-when-scattered-below-
  horizon check (`dot(scattered, n) > 0`), which the reference omits.
- Dielectric (`shade.wgsl:148-187`): refraction ratio by front face, total
  internal reflection, Schlick fresnel vs a fresh uniform, attenuation 1.
  The reference never spawns a dielectric (`src/sphere.rs:61-91`, glass
  branch is commented-out C++); here it is a first-class, tested material
  (SURVEY.md §7 checklist item 3).
- Sky gradient miss shading (`shade.wgsl:189-197`):
  lerp(white, (0.5,0.7,1.0), 0.5*(dir.y + 1)).

Branch-free: the 3-way material branch (`shade.wgsl:240-252`) is the
MoE-like dispatch SURVEY.md §2.3 calls out — here all three scatter models
are computed densely for every lane and combined with `jnp.where` by material
kind (branch-free; no routing, no divergence).

Gradients: scatter directions and attenuations are differentiable w.r.t.
normals/albedo/fuzz/IOR given the sampled random numbers (reparameterized);
discrete choices (reflect-vs-refract comparison, horizon check, near-zero
guard) are boolean masks with no gradient path, i.e. straight-through on
the sampled branch.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bevy_raytrace_tpu.core.types import DIELECTRIC, LAMBERTIAN, METALLIC
from bevy_raytrace_tpu.rng.pcg import random_in_unit_sphere, random_unit_vector

_NEAR_ZERO = 1.0e-8


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize_guarded(v):
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    inv = jax_rsqrt_guard(n2)
    return v * inv


def jax_rsqrt_guard(n2, eps=1.0e-20):
    return 1.0 / jnp.sqrt(jnp.maximum(n2, eps))


_SKY_WHITE = np.array([1.0, 1.0, 1.0], np.float32)
_SKY_BLUE = np.array([0.5, 0.7, 1.0], np.float32)


def sky_color(unit_dir):
    """Background gradient, shade.wgsl:189-197."""
    t = 0.5 * (unit_dir[..., 1] + 1.0)
    return (1.0 - t)[..., None] * _SKY_WHITE + t[..., None] * _SKY_BLUE


def reflect(v, n):
    """Mirror reflection, shade.wgsl:132-137 / RTiOW reflect."""
    return v - 2.0 * _dot(v, n)[..., None] * n


def refract(unit_v, n, etai_over_etat, cos_theta):
    """Snell refraction, RTiOW form (shade.wgsl:163-180).

    The sqrt is guarded at the total-internal-reflection boundary
    (k -> 0): sqrt'(0) = inf would otherwise leak infinities into the
    gradient whenever a sampled refraction grazes the TIR limit — seen
    in practice at flagship sample counts (r4).  Values are unchanged;
    the unbounded boundary derivative is straight-through dropped below
    k = 1e-12, the same policy as the tangency guard on hit distances
    (inverse/fast_grad.py)."""
    import jax

    r_out_perp = etai_over_etat[..., None] * (unit_v + cos_theta[..., None] * n)
    k = jnp.abs(1.0 - jnp.sum(r_out_perp * r_out_perp, axis=-1))
    k_ok = k > 1e-12
    sqrt_k = jnp.where(k_ok, jnp.sqrt(jnp.where(k_ok, k, 1.0)),
                       jax.lax.stop_gradient(jnp.sqrt(k)))
    r_out_parallel = -sqrt_k[..., None] * n
    return r_out_perp + r_out_parallel


def schlick(cos_theta, refl_ratio):
    """Schlick fresnel approximation, shade.wgsl:156-161."""
    r0 = (1.0 - refl_ratio) / (1.0 + refl_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def scatter(unit_dir, hit_normal, front_face, albedo, kind, fuzz, ior, u):
    """Branch-free scatter for a ray batch.

    Args:
      unit_dir: [R,3] incident unit direction.
      hit_normal: [R,3] shading normal (front-facing).
      front_face: [R] bool.
      albedo/kind/fuzz/ior: per-ray gathered material attributes.
      u: tuple of four uniforms (u1..u4), each [R].

    Returns (new_dir [R,3], attenuation [R,3], scatter_ok [R]).
    """
    u1, u2, u3, u4 = u

    # --- Lambertian -------------------------------------------------------
    ruv = random_unit_vector(u1, u2)  # [R,3]
    lam_raw = hit_normal + ruv
    lam_degenerate = jnp.sum(jnp.abs(lam_raw), axis=-1) < _NEAR_ZERO
    lam_dir = _normalize_guarded(
        jnp.where(lam_degenerate[:, None], hit_normal, lam_raw)
    )

    # --- Metallic ---------------------------------------------------------
    reflected = reflect(unit_dir, hit_normal)
    fuzz_vec = fuzz[:, None] * random_in_unit_sphere(u1, u2, u3)
    met_raw = reflected + fuzz_vec
    met_dir = _normalize_guarded(met_raw)
    met_ok = _dot(met_dir, hit_normal) > 0.0  # RTiOW absorb check

    # --- Dielectric -------------------------------------------------------
    refraction_ratio = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(_dot(-unit_dir, hit_normal), 1.0)
    sin2 = jnp.maximum(0.0, 1.0 - cos_theta * cos_theta)
    sin_theta = jnp.sqrt(sin2)
    cannot_refract = refraction_ratio * sin_theta > 1.0
    refl_prob = schlick(cos_theta, refraction_ratio)
    use_reflect = cannot_refract | (refl_prob > u4)
    refracted = refract(unit_dir, hit_normal, refraction_ratio, cos_theta)
    die_dir = _normalize_guarded(
        jnp.where(use_reflect[:, None], reflected, refracted)
    )

    # --- combine by material kind (dense select, no divergence) -----------
    is_lam = (kind == LAMBERTIAN)[:, None]
    is_met = (kind == METALLIC)[:, None]
    is_die = (kind == DIELECTRIC)[:, None]
    new_dir = jnp.where(is_lam, lam_dir, jnp.where(is_met, met_dir, die_dir))
    ones = jnp.ones_like(albedo)
    attenuation = jnp.where(is_die, ones, albedo)
    scatter_ok = jnp.where(kind == METALLIC, met_ok, True)
    return new_dir, attenuation, scatter_ok
