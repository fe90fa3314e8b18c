"""Counter-based RNG for the path tracer (PCG4D).

The reference seeds a Hugo-Elias integer hash with
`pixel_x + W*pixel_y + W*H*frame` once per pixel per frame and reuses the
same three random numbers across every bounce and material event of the
frame (`assets/shaders/shade.wgsl:216-218`, `generate.wgsl:52-63`) — a
correlation bug SURVEY.md flags as not-to-replicate.  Here every draw is a
pure function of a 4D counter `(pixel, sample, bounce/stream, seed)` hashed
with PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering", JCGT
2020 — a public, widely used construction).  Consequences:

- decorrelated per-bounce, per-event samples (correct RTiOW Monte Carlo);
- identical streams regardless of device mesh / sharding layout, because
  the counter is the *absolute* pixel id, never a shard-local index;
- the same sequence replays in forward and backward passes, so
  `jax.grad` differentiates the *sampled* path (reparameterization);
- pure uint32 vector arithmetic: runs identically under jnp on CPU/GPU and
  inside the Pallas GPU kernel (`kernels/trace_gpu.py` calls this exact
  function), and is trivially mirrored in numpy for the naive oracle
  renderer used by the golden tests.

Gradients: draws are constants w.r.t. scene parameters (integer pipeline),
which is exactly the reparameterized-sampling contract.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_INV_2POW24 = np.float32(1.0 / 16777216.0)  # 2**-24


def _as_u32(v):
    """uint32 cast that keeps host values on the host.

    Constants that stay numpy are embedded directly into the lowered
    program; a `jnp` cast would eagerly create a device array whose value
    lowering must fetch back — a pointless round-trip."""
    if isinstance(v, (np.ndarray, np.integer, int)):
        return np.asarray(v, np.uint32)
    return v.astype(jnp.uint32)


def pcg4d(x, y, z, w):
    """PCG4D hash: four uint32 counters -> four decorrelated uint32s.

    Vectorized over broadcasting inputs (numpy arrays, python ints, or
    traced jax values — host inputs stay on the host).  All arithmetic
    wraps mod 2**32.
    """
    x = _as_u32(x)
    y = _as_u32(y)
    z = _as_u32(z)
    w = _as_u32(w)

    mul = np.uint32(1664525)
    add = np.uint32(1013904223)
    # np.errstate: uint32 wrap-around is the point; numpy warns on scalar
    # overflow (a no-op for traced values).
    with np.errstate(over="ignore"):
        x = x * mul + add
        y = y * mul + add
        z = z * mul + add
        w = w * mul + add

        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z

        x = x ^ (x >> 16)
        y = y ^ (y >> 16)
        z = z ^ (z >> 16)
        w = w ^ (w >> 16)

        x = x + y * w
        y = y + z * x
        z = z + x * y
        w = w + y * z
    return x, y, z, w


def _to_unit_float(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> np.uint32(8)).astype(jnp.float32) * _INV_2POW24


def uniform4(pixel_id, sample_id, stream, seed):
    """Four uniforms in [0,1) for counter (pixel, sample, stream, seed).

    `stream` separates draw sites: by convention stream = bounce index for
    scatter events, and dedicated high streams for camera-ray generation
    (see wavefront/render.py).
    """
    a, b, c, d = pcg4d(pixel_id, sample_id, stream, seed)
    return (
        _to_unit_float(a),
        _to_unit_float(b),
        _to_unit_float(c),
        _to_unit_float(d),
    )


# --- geometric sampling primitives (RTiOW samplers, reparameterized) -------


def random_unit_vector(u1, u2):
    """Uniform direction on the unit sphere from two uniforms.

    Replaces the reference's positive-octant-biased `normalize(seed)` with
    seed in [0,1)^3 (`assets/shaders/shade.wgsl:121` — flagged in SURVEY.md
    as a bias not to replicate); this is the correct RTiOW
    `random_unit_vector`.
    """
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * jnp.pi) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def random_in_unit_sphere(u1, u2, u3):
    """Uniform point inside the unit sphere (for metal fuzz perturbation,
    RTiOW `random_in_unit_sphere`; reference uses the biased hash directly,
    `assets/shaders/shade.wgsl:139`)."""
    return random_unit_vector(u1, u2) * jnp.cbrt(u3)[..., None]


def random_in_unit_disk(u1, u2):
    """Uniform point in the unit disk (thin-lens aperture sampling; the
    reference's lens sampler exists but is fed `lens_offset=(0,0)`,
    `assets/shaders/generate.wgsl:85-107,121` — here it is live)."""
    r = jnp.sqrt(u1)
    phi = (2.0 * jnp.pi) * u2
    return r * jnp.cos(phi), r * jnp.sin(phi)
