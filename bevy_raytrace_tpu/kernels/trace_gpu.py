"""Fused whole-path trace kernel for the GPU (Pallas through Triton).

One program owns a power-of-two block of pixels and traces every sample of
every pixel in it: camera ray generation, each (intersect -> shade)
bounce, and the sample average, with all per-ray state in registers.  The
only device-memory traffic is the sphere table (a few KB, cache resident),
the framebuffer and, when recording, the int16 winner residuals.  The XLA
wavefront (`wavefront/render.py`) instead materializes [rays, spheres]
planes per bounce.

Structure, after the reference's own per-thread shader
(`intersect.wgsl:132-143,154`):
- the sample loop runs inside the program, so nothing carries between
  programs and the grid is one axis over pixel blocks;
- the sphere loop is a brute-force `fori_loop` over scalar rows of the
  [S, 11] table, tracking only the running nearest t and winner index;
  the winner's attributes are gathered per lane once per bounce;
- the bounce loop is a `while_loop` that exits once no lane of the block
  is alive; residual slots of the skipped bounces are filled with -1;
- masked stores cover the padded tail of the last block.

RNG: `rng/pcg.py`'s PCG4D on the same (absolute pixel, sample, stream,
seed) counters as the XLA path, so images agree with `wavefront.render`
to f32 rounding and compose across pixel stripes bit-exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.rng.pcg import uniform4
from bevy_raytrace_tpu.wavefront.render import CAMERA_STREAM, frame_seed

BLOCK = 128  # pixels per program
NUM_WARPS = 4

# Sphere-table columns.
_CX, _CY, _CZ, _KQ, _IVR, _AR, _AG, _AB, _KIND, _FUZZ, _IOR = range(11)
_TWO_PI = np.float32(2.0 * np.pi)


def _rsqrt_guard(n2):
    return jax.lax.rsqrt(jnp.maximum(n2, np.float32(1e-20)))


def kernel_table(scene):
    """[S, 11] f32 per-sphere rows [cx, cy, cz, |c|^2 - r^2, 1/r, albedo
    rgb, kind, fuzz, ior]; 1/r keeps the radius sign (negative radius =
    inward normal)."""
    c = scene.centers
    r = scene.radii
    m = scene.materials
    mid = scene.material_id
    tbl = jnp.concatenate([
        c,
        (jnp.sum(c * c, axis=-1) - r * r)[:, None],
        (1.0 / r)[:, None],
        m.albedo[mid],
        m.kind[mid].astype(jnp.float32)[:, None],
        m.fuzz[mid][:, None],
        m.ior[mid][:, None],
    ], axis=1).astype(jnp.float32)
    return tbl


def _trace_kernel(tbl_ref, cam_ref, seed_ref, fb_ref, *res_refs, config,
                  npix, block, sample_base, record_second):
    width, height = config.width, config.height
    t_min = np.float32(config.t_min)
    t_max = np.float32(config.t_max)
    depth = config.max_depth
    spp = config.samples_per_pixel
    n_spheres = tbl_ref.shape[0]
    res_ref = res_refs[0] if res_refs else None
    res2_ref = res_refs[1] if record_second else None

    lane = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    valid = lane < npix
    seed = seed_ref[0]
    pix = seed_ref[1] + lane.astype(jnp.uint32)  # absolute pixel id
    xf = (pix % np.uint32(width)).astype(jnp.float32)
    yf = (pix // np.uint32(width)).astype(jnp.float32)

    cox, coy, coz = cam_ref[0], cam_ref[1], cam_ref[2]
    ux, uy, uz = cam_ref[3], cam_ref[4], cam_ref[5]
    vx, vy, vz = cam_ref[6], cam_ref[7], cam_ref[8]
    wx, wy, wz = cam_ref[9], cam_ref[10], cam_ref[11]
    half_w, half_h = cam_ref[12], cam_ref[13]
    lens_r, focus = cam_ref[14], cam_ref[15]

    zero = jnp.zeros((block,), jnp.float32)
    one = jnp.ones((block,), jnp.float32)
    minus1 = jnp.full((block,), -1, jnp.int32)

    def nearest(ox, oy, oz, dx, dy, dz):
        """Brute-force nearest hit: (t, winner) and, when recording the
        runner-up, (t2, second) = nearest hit excluding the winner."""
        o_dot_d = ox * dx + oy * dy + oz * dz
        o2 = ox * ox + oy * oy + oz * oz

        def one_sphere(n, carry):
            bt, bi = carry[0], carry[1]
            cx = tbl_ref[n, _CX]
            cy = tbl_ref[n, _CY]
            cz = tbl_ref[n, _CZ]
            half_b = o_dot_d - (cx * dx + cy * dy + cz * dz)
            cq = o2 - 2.0 * (ox * cx + oy * cy + oz * cz) + tbl_ref[n, _KQ]
            # sqrt(disc < 0) is NaN and fails every compare below.
            # Unit directions: a == 1 (the XLA path divides by |d|^2).
            sq = jnp.sqrt(half_b * half_b - cq)
            rn = -half_b - sq
            tn = jnp.where(rn > t_min, rn, sq - half_b)
            ok = tn > t_min
            better = ok & (tn < bt)
            out = (jnp.where(better, tn, bt), jnp.where(better, n, bi))
            if record_second:
                bt2, bi2 = carry[2], carry[3]
                sec = ok & ~better & (tn < bt2)
                out += (jnp.where(better, bt, jnp.where(sec, tn, bt2)),
                        jnp.where(better, bi, jnp.where(sec, n, bi2)))
            return out

        init = (jnp.full((block,), t_max, jnp.float32), minus1)
        if record_second:
            init += init
        return jax.lax.fori_loop(0, n_spheres, one_sphere, init)

    def bounce(state, sample):
        (b, ox, oy, oz, dx, dy, dz,
         tp_r, tp_g, tp_b, rad_r, rad_g, rad_b, alive) = state
        found = nearest(ox, oy, oz, dx, dy, dz)
        bt, bi = found[0], found[1]
        hit = bt < t_max
        if res_ref is not None:
            rec = jnp.where(hit & alive, bi, -1).astype(res_ref.dtype)
            plgpu.store(res_ref.at[sample, b, lane], rec, mask=valid)
        if res2_ref is not None:
            rec2 = jnp.where(hit & (found[2] < t_max) & alive, found[3], -1)
            plgpu.store(res2_ref.at[sample, b, lane],
                        rec2.astype(res2_ref.dtype), mask=valid)

        w = jnp.maximum(bi, 0)

        def attr(col):
            return plgpu.load(tbl_ref.at[w, col])

        t_safe = jnp.where(hit, bt, 0.0)
        hx = ox + t_safe * dx
        hy = oy + t_safe * dy
        hz = oz + t_safe * dz
        ivr = attr(_IVR)
        nx = jnp.where(hit, (hx - attr(_CX)) * ivr, 0.0)
        ny = jnp.where(hit, (hy - attr(_CY)) * ivr, 0.0)
        nz = jnp.where(hit, (hz - attr(_CZ)) * ivr, 1.0)
        front = (dx * nx + dy * ny + dz * nz) < 0.0
        sgn = jnp.where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        u1, u2, u3, u4 = uniform4(pix, sample_id(sample), b, seed)
        # unit-sphere sample
        zs = 1.0 - 2.0 * u1
        rs = jnp.sqrt(jnp.maximum(0.0, 1.0 - zs * zs))
        ph = _TWO_PI * u2
        rux, ruy, ruz = rs * jnp.cos(ph), rs * jnp.sin(ph), zs

        # Lambertian
        lx, ly, lz = nx + rux, ny + ruy, nz + ruz
        lam_deg = (jnp.abs(lx) + jnp.abs(ly) + jnp.abs(lz)) < 1e-8
        lx = jnp.where(lam_deg, nx, lx)
        ly = jnp.where(lam_deg, ny, ly)
        lz = jnp.where(lam_deg, nz, lz)
        linv = _rsqrt_guard(lx * lx + ly * ly + lz * lz)
        lx, ly, lz = lx * linv, ly * linv, lz * linv

        # metal
        ddn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * ddn * nx
        ry = dy - 2.0 * ddn * ny
        rz = dz - 2.0 * ddn * nz
        fz = attr(_FUZZ) * jnp.cbrt(u3)
        mx, my, mz = rx + fz * rux, ry + fz * ruy, rz + fz * ruz
        minv = _rsqrt_guard(mx * mx + my * my + mz * mz)
        mx, my, mz = mx * minv, my * minv, mz * minv
        met_ok = (mx * nx + my * ny + mz * nz) > 0.0

        # dielectric
        ior = attr(_IOR)
        ratio = jnp.where(front, 1.0 / ior, ior)
        cos_t = jnp.minimum(-ddn, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        m1 = 1.0 - cos_t
        m2 = m1 * m1
        schlick = r0 + (1.0 - r0) * (m2 * m2 * m1)
        use_refl = (ratio * sin_t > 1.0) | (schlick > u4)
        ppx = ratio * (dx + cos_t * nx)
        ppy = ratio * (dy + cos_t * ny)
        ppz = ratio * (dz + cos_t * nz)
        sqk = jnp.sqrt(jnp.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)))
        ex = jnp.where(use_refl, rx, ppx - sqk * nx)
        ey = jnp.where(use_refl, ry, ppy - sqk * ny)
        ez = jnp.where(use_refl, rz, ppz - sqk * nz)
        einv = _rsqrt_guard(ex * ex + ey * ey + ez * ez)
        ex, ey, ez = ex * einv, ey * einv, ez * einv

        # select by material kind (0 Lambertian, 1 metal, 2 dielectric)
        kind = attr(_KIND)
        is_lam = kind < 0.5
        is_met = (kind > 0.5) & (kind < 1.5)
        is_die = kind > 1.5
        sx = jnp.where(is_lam, lx, jnp.where(is_met, mx, ex))
        sy = jnp.where(is_lam, ly, jnp.where(is_met, my, ey))
        sz = jnp.where(is_lam, lz, jnp.where(is_met, mz, ez))
        at_r = jnp.where(is_die, 1.0, attr(_AR))
        at_g = jnp.where(is_die, 1.0, attr(_AG))
        at_b = jnp.where(is_die, 1.0, attr(_AB))

        # sky on miss: lerp(white, (0.5, 0.7, 1.0), 0.5 * (dir.y + 1))
        tsky = 0.5 * (dy + 1.0)
        sky = alive & ~hit
        rad_r = rad_r + jnp.where(sky, tp_r * (1.0 - 0.5 * tsky), 0.0)
        rad_g = rad_g + jnp.where(sky, tp_g * (1.0 - 0.3 * tsky), 0.0)
        rad_b = rad_b + jnp.where(sky, tp_b, 0.0)

        scat = alive & hit
        tp_r = jnp.where(scat, tp_r * at_r, tp_r)
        tp_g = jnp.where(scat, tp_g * at_g, tp_g)
        tp_b = jnp.where(scat, tp_b * at_b, tp_b)
        alive = scat & (~is_met | met_ok)
        return (b + 1,
                jnp.where(alive, hx, ox), jnp.where(alive, hy, oy),
                jnp.where(alive, hz, oz), jnp.where(alive, sx, dx),
                jnp.where(alive, sy, dy), jnp.where(alive, sz, dz),
                tp_r, tp_g, tp_b, rad_r, rad_g, rad_b, alive)

    def sample_id(s):
        return (s + sample_base).astype(jnp.uint32)

    def one_sample(s, acc):
        cu1, cu2, cu3, cu4 = uniform4(pix, sample_id(s), CAMERA_STREAM, seed)
        s_im = (xf + cu1) / np.float32(width)
        t_im = 1.0 - (yf + cu2) / np.float32(height)
        ru = jnp.sqrt(cu3)
        phi = _TWO_PI * cu4
        du = ru * jnp.cos(phi) * lens_r
        dv = ru * jnp.sin(phi) * lens_r
        ox = cox + du * ux + dv * vx
        oy = coy + du * uy + dv * vy
        oz = coz + du * uz + dv * vz
        su = (2.0 * s_im - 1.0) * half_w * focus
        tv = (2.0 * t_im - 1.0) * half_h * focus
        tx = cox - focus * wx + su * ux + tv * vx - ox
        ty = coy - focus * wy + su * uy + tv * vy - oy
        tz = coz - focus * wz + su * uz + tv * vz - oz
        inv = _rsqrt_guard(tx * tx + ty * ty + tz * tz)

        state = (jnp.int32(0), ox, oy, oz, tx * inv, ty * inv, tz * inv,
                 one, one, one, zero, zero, zero, valid)

        def live(st):
            # No reduce_or on this route: any() as a max over int32.
            return (st[0] < depth) & (jnp.max(st[-1].astype(jnp.int32)) > 0)

        state = jax.lax.while_loop(live, lambda st: bounce(st, s), state)
        if res_ref is not None:
            # Bounces skipped by the whole-block early exit record misses.
            def fill(b, carry):
                for ref in res_refs:
                    plgpu.store(ref.at[s, b, lane],
                                minus1.astype(ref.dtype), mask=valid)
                return carry

            jax.lax.fori_loop(state[0], depth, fill, jnp.int32(0))
        return (acc[0] + state[10], acc[1] + state[11], acc[2] + state[12])

    acc = jax.lax.fori_loop(0, spp, one_sample, (zero, zero, zero))
    inv_spp = np.float32(1.0 / spp)
    for c in range(3):
        plgpu.store(fb_ref.at[c, lane], acc[c] * inv_spp, mask=valid)


def render_pallas(
    scene,
    camera,
    config: RenderConfig,
    frame=0,
    interpret: bool = False,
    with_residuals: bool = False,
    record_second: bool = False,
    sample_base: int = 0,
    pixel_base=None,
    num_local: int | None = None,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
):
    """The fused trace kernel -> linear f32 image [H, W, 3].

    Agrees with `wavefront.render` to f32 rounding (same RNG counters and
    math; transcendental codegen differs).

    `with_residuals=True` also returns the per-bounce winner sphere index
    `res` int16 [spp, max_depth, P] (-1 = miss or dead path): the
    checkpoint that lets `inverse.fast_grad` replay the sampled paths
    without a sphere sweep.  `record_second=True` appends `res2`, the
    runner-up (nearest hit excluding the winner; -1 when none), used by
    the two-sided soft-silhouette term.

    `sample_base` offsets the absolute sample ids, so a render of samples
    [base, base + spp) draws the paths those samples draw in one render.

    Stripe mode: `num_local` (static) renders only the `num_local` pixels
    starting at absolute pixel `pixel_base` (may be traced, e.g. a mesh
    rank times the stripe).  Returns the flat [num_local, 3] stripe and
    stripe-local residuals; stripes compose bit-exactly.

    `interpret=True` runs the Pallas interpreter (CPU tests); it is never
    chosen implicitly.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            f"the fused trace kernel compiles only for the GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it in "
            f"the Pallas interpreter")
    if record_second and not with_residuals:
        raise ValueError("record_second requires with_residuals")
    if block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    stripe = num_local is not None
    npix = num_local if stripe else config.num_pixels
    if config.max_depth == 0:  # no bounce: black, no residuals
        img = jnp.zeros((npix, 3), jnp.float32)
        img = img if stripe else img.reshape(config.height, config.width, 3)
        res = jnp.zeros((config.samples_per_pixel, 0, npix), jnp.int16)
        if not with_residuals:
            return img
        return (img, res, res) if record_second else (img, res)
    tbl = kernel_table(scene)
    if tbl.shape[0] > 32767:
        raise ValueError(f"{scene.count} spheres exceed the int16 residuals")
    base = 0 if pixel_base is None else pixel_base
    seed_arr = jnp.stack([
        jnp.asarray(frame_seed(config, frame), jnp.uint32).reshape(()),
        jnp.asarray(base).astype(jnp.uint32).reshape(()),
    ])

    out_shape = [jax.ShapeDtypeStruct((3, npix), jnp.float32)]
    if with_residuals:
        res_shape = jax.ShapeDtypeStruct(
            (config.samples_per_pixel, config.max_depth, npix), jnp.int16)
        out_shape += [res_shape] * (2 if record_second else 1)
    kernel = functools.partial(
        _trace_kernel, config=config, npix=npix, block=block,
        sample_base=sample_base, record_second=record_second)
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(npix, block),),
        out_shape=tuple(out_shape),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="trace_paths",
    )(tbl, camera.pack(), seed_arr)
    fb = outs[0].T
    img = fb if stripe else fb.reshape(config.height, config.width, 3)
    if not with_residuals:
        return img
    return (img, *outs[1:])
