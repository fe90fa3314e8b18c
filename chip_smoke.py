#!/usr/bin/env python
"""Bring-up smoke run of the renderer and its gradient on the GPU.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the sharded phase only

Phases (one GPU), each through the entry points a user calls, at sizes a
user would call real, every kernel compiled for the card:
  device     — JAX sees a GPU; prints it and nvidia-smi's name and power
               limit.
  forward    — RTiOW final scene (486 spheres, defocus camera) at
               1200x800, depth 8: 64 spp through Renderer(backend="pallas")
               (the fused Triton kernel); the parity gate of bench.py
               against the XLA wavefront at 8 spp; the kernel's int16
               residuals against the XLA recorder's winners.
  reference  — `cli render` of the upstream project's own frame
               (1920x1080, 1 spp, depth 3, 197 spheres), then both
               forwards timed at that frame.
  gradient   — value_and_grad through make_fast_renderer (kernel record +
               XLA replay) at 400x300x16 spp, depth 8, against jax.grad of
               the XLA wavefront (bulk agreement); then `cli inverse` for 5
               steps, whose loss must be finite and fall.
  decisions  — both timings of each kernel decision: the Triton forward
               against the XLA forward, the XLA intersection's inner-
               product planes as elementwise sums against HIGHEST-
               precision matmuls, and the replay's winner-gather
               transpose as scatter-add against a one-hot matmul.
  gpu tests  — `pytest -m gpu` in this process.

With --four: a sharded render of the flagship on 4 GPUs (the kernel's and
the wavefront's stripes) against the single-device XLA render, a check
that the 4 stripes live on 4 distinct devices, and a sharded fast-gradient
step against the single-device fast path.

Each phase prints one line with its times, compile seconds and
peak_bytes_in_use.  Any failure exits non-zero.  The last line of stdout
is exactly {"ok": true, "device": {"platform", "kind", "count"}}.
Everything runs in this one process: a second JAX process would find the
card's memory taken.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

import bevy_raytrace_tpu  # noqa: F401  (fails outside a checkout)
from bevy_raytrace_tpu import RenderConfig
from bevy_raytrace_tpu.utils.device import (
    device_record,
    gpu_info,
    require_gpu,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# The parity gate (bench.py): median abs error, share of pixels off by
# more than 1e-2, |per-channel mean bias|.  fma contraction and the GPU's
# approximate sqrt/rsqrt flip rare discrete path choices; a wrong kernel
# misses all three bounds by orders of magnitude.
GATE_MEDIAN, GATE_BAD_FRAC, GATE_BAD_TOL, GATE_BIAS = 1e-5, 0.02, 1e-2, 5e-4
RESIDUAL_MAX_DIFF = 0.02  # share of paths whose recorded winners differ


def log(msg):
    print(msg, flush=True)


def last_line(devices) -> str:
    """The final stdout line: {"ok": true, "device": {...}}."""
    return json.dumps({"ok": True, "device": device_record(devices)})


def peak_bytes(device=None):
    """peak_bytes_in_use of `device` (default the first), or None where
    the backend keeps no memory statistics."""
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def timed(fn, *args, repeats=2):
    """(seconds of the first call incl. compile, best warm seconds, out)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def parity_gate(got, ref):
    """-> (ok, median, bad share, bias) of `got` against `ref`."""
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    err = np.abs(d).max(axis=-1)
    med = float(np.median(err))
    bad = float((err > GATE_BAD_TOL).mean())
    bias = float(np.abs(d.reshape(-1, 3).mean(axis=0)).max())
    ok = bool(np.isfinite(err).all() and med <= GATE_MEDIAN
              and bad <= GATE_BAD_FRAC and bias <= GATE_BIAS)
    return ok, med, bad, bias


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def xla_config(width, height, spp, depth, **kw):
    """A RenderConfig whose XLA wavefront works on 480k-ray chunks (one
    [rays, spheres] f32 plane ~0.93 GB at 486 spheres)."""
    npix = width * height
    return RenderConfig(width=width, height=height, samples_per_pixel=spp,
                        max_depth=depth, spp_chunk=min(spp, 4),
                        ray_chunk=120_000 if npix % 120_000 == 0 else 0,
                        **kw)


def flagship_scene(grid=11):
    from bevy_raytrace_tpu.scenes import rtiow_final_camera, rtiow_final_scene

    scene, _ = rtiow_final_scene(seed=0, grid=grid)
    return scene, rtiow_final_camera


# ---------------------------------------------------------------- phases


def device_phase():
    """-> devices; fails unless JAX's first device is a GPU."""
    devices = require_gpu()
    rec = device_record(devices)
    smi, _ = gpu_info()
    log(f"device: platform={rec['platform']} kind={rec['kind']} "
        f"count={rec['count']}")
    log(f"nvidia-smi: {smi}")
    return devices


def forward_phase(width=1200, height=800, spp=64, parity_spp=8, depth=8,
                  grid=11, interpret=False):
    """Flagship forward: kernel rays/s, parity gate, residual agreement.
    Returns the timings the decisions phase reports."""
    from bevy_raytrace_tpu.kernels import render_pallas
    from bevy_raytrace_tpu.wavefront import Renderer
    from bevy_raytrace_tpu.wavefront.render import render, render_record

    scene, cam_fn = flagship_scene(grid)
    cfg = xla_config(width, height, spp, depth)
    cam = cam_fn(cfg.aspect)
    r = Renderer(cfg, backend="pallas", interpret=interpret)
    compile_s = r.warmup(scene, cam)
    t0 = time.perf_counter()
    img = np.asarray(jax.block_until_ready(r.render_frame(scene, cam)))
    frame_s = time.perf_counter() - t0
    check(img.shape == (height, width, 3) and np.isfinite(img).all(),
          "kernel image is not finite")
    kernel_rps = cfg.rays_per_frame / frame_s

    small = xla_config(width, height, parity_spp, depth)
    kern = jax.jit(lambda s, c: render_pallas(s, c, small, 0,
                                              interpret=interpret))
    xla = jax.jit(lambda s, c: render(s, c, small, 0))
    k_first, k_best, k_img = timed(kern, scene, cam)
    x_first, x_best, x_img = timed(xla, scene, cam)
    ok, med, bad, bias = parity_gate(k_img, x_img)

    rec_k = jax.jit(lambda s, c: render_pallas(
        s, c, small, 0, interpret=interpret, with_residuals=True)[1])
    rec_x = jax.jit(lambda s, c: render_record(s, c, small, 0)[1])
    res_k = np.asarray(rec_k(scene, cam))
    res_x = np.asarray(rec_x(scene, cam))
    check(res_k.dtype == np.int16 and res_k.shape == res_x.shape,
          f"residuals {res_k.dtype}{res_k.shape} vs {res_x.shape}")
    res_diff = float((res_k != res_x).any(axis=1).mean())
    log(f"forward: {width}x{height}x{spp}spp depth {depth}, {scene.count} "
        f"spheres: kernel {frame_s:.3f}s/frame = {kernel_rps:,.0f} rays/s "
        f"(compile {compile_s:.1f}s); parity at {parity_spp}spp: "
        f"median={med:.2e} frac>{GATE_BAD_TOL}={bad:.4f} bias={bias:.2e} "
        f"-> {'ok' if ok else 'FAIL'}; residual paths differing "
        f"{res_diff:.4%}; peak_bytes_in_use={peak_bytes()}")
    check(ok, "parity gate failed: kernel disagrees with the XLA wavefront")
    check(res_diff <= RESIDUAL_MAX_DIFF,
          f"{res_diff:.2%} of recorded paths differ from the XLA recorder")
    rays = small.rays_per_frame
    return {"config": f"{width}x{height}x{parity_spp}spp depth {depth}",
            "kernel_s": k_best, "kernel_compile_s": k_first - k_best,
            "xla_s": x_best, "xla_compile_s": x_first - x_best,
            "kernel_rps": rays / k_best, "xla_rps": rays / x_best}


def reference_phase(width=1920, height=1080, spp=1, depth=3,
                    interpret=False, out_dir=OUT_DIR):
    """The upstream frame through `cli render`, then both forwards timed."""
    from bevy_raytrace_tpu import cli
    from bevy_raytrace_tpu.kernels import render_pallas
    from bevy_raytrace_tpu.scenes import reference_scene, rtiow_final_camera
    from bevy_raytrace_tpu.wavefront.render import render

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "reference.png")
    argv = ["render", "--scene", "reference", "--width", str(width),
            "--height", str(height), "--spp", str(spp), "--depth",
            str(depth), "--backend", "pallas", "-o", out]
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli.main(argv + (["--interpret"] if interpret else []))
    cli_s = time.perf_counter() - t0
    check(os.path.getsize(out) > 100, "cli render wrote no image")

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth)
    scene, _ = reference_scene(seed=0)
    cam = rtiow_final_camera(cfg.aspect)
    kern = jax.jit(lambda s, c: render_pallas(s, c, cfg, 1,
                                              interpret=interpret))
    xla = jax.jit(lambda s, c: render(s, c, cfg, 1))
    _, k_best, k_img = timed(kern, scene, cam, repeats=3)
    _, x_best, x_img = timed(xla, scene, cam, repeats=3)
    ok, med, bad, bias = parity_gate(k_img, x_img)
    rays = cfg.rays_per_frame
    log(f"reference: {width}x{height}x{spp}spp depth {depth}, "
        f"{scene.count} spheres: cli render {cli_s:.1f}s (compile incl.); "
        f"kernel {k_best * 1e3:.2f} ms = {rays / k_best:,.0f} rays/s, "
        f"xla {x_best * 1e3:.2f} ms = {rays / x_best:,.0f} rays/s; parity "
        f"median={med:.2e} frac>{GATE_BAD_TOL}={bad:.4f} bias={bias:.2e}; "
        f"peak_bytes_in_use={peak_bytes()}")
    check(ok, "reference frame: kernel disagrees with the XLA wavefront")
    return {"kernel_rps": rays / k_best, "xla_rps": rays / x_best}


def _centers_step(render_fn, scene, camera):
    def loss(centers):
        sc = dataclasses.replace(scene, centers=centers)
        return jnp.mean(render_fn(sc, camera, 1) ** 2)
    return jax.jit(jax.value_and_grad(loss))


def bulk_agreement(g_fast, g_xla):
    """tests/test_fast_grad.py's contract: the 98%-trimmed max |diff|
    stays below 0.3 x p99 |g_xla| -> (ok, trimmed max, scale)."""
    d = np.sort(np.abs(np.ravel(g_fast) - np.ravel(g_xla)))
    trimmed = float(d[: int(0.98 * d.size)].max())
    scale = float(np.percentile(np.abs(g_xla), 99))
    ok = bool(np.isfinite(g_fast).all() and np.isfinite(g_xla).all()
              and trimmed < 0.3 * scale)
    return ok, trimmed, scale


def gradient_phase(width=400, height=300, spp=16, depth=8, steps=5,
                   grid=11, interpret=False, out_dir=OUT_DIR):
    """Fast gradient vs jax.grad of XLA, then `cli inverse`."""
    from bevy_raytrace_tpu import cli
    from bevy_raytrace_tpu.inverse import make_fast_renderer
    from bevy_raytrace_tpu.wavefront.render import render

    scene, cam_fn = flagship_scene(grid)
    cfg = xla_config(width, height, spp, depth)
    cam = cam_fn(cfg.aspect)
    fast = _centers_step(make_fast_renderer(cfg, interpret=interpret),
                         scene, cam)
    f_first, f_best, (_, g_fast) = timed(fast, scene.centers)
    with jax.default_matmul_precision("highest"):
        xla = _centers_step(lambda s, c, f: render(s, c, cfg, f), scene, cam)
        x_first, x_best, (_, g_xla) = timed(xla, scene.centers)
    ok, trimmed, scale = bulk_agreement(np.asarray(g_fast),
                                        np.asarray(g_xla))

    os.makedirs(out_dir, exist_ok=True)
    err = io.StringIO()
    argv = ["inverse", "--backend", "pallas", "--width", str(width),
            "--height", str(height), "--spp", str(spp), "--depth",
            str(depth), "--steps", str(steps), "-o",
            os.path.join(out_dir, "inverse.png")]
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        cli.main(argv + (["--interpret"] if interpret else []))
    cli_s = time.perf_counter() - t0
    losses = [float(line.split("loss")[1]) for line in
              err.getvalue().splitlines() if line.startswith("step ")]
    falls = (len(losses) >= 2 and np.isfinite(losses).all()
             and losses[-1] < losses[0])
    paths = cfg.rays_per_frame
    log(f"gradient: {width}x{height}x{spp}spp depth {depth}: fast "
        f"{f_best:.3f}s/step = {paths / f_best:,.0f} paths/s (compile "
        f"{f_first - f_best:.1f}s), xla {x_best:.3f}s/step = "
        f"{paths / x_best:,.0f} paths/s (compile {x_first - x_best:.1f}s); "
        f"bulk agreement trimmed={trimmed:.3e} < 0.3 x {scale:.3e} -> "
        f"{'ok' if ok else 'FAIL'}; cli inverse {steps} steps in "
        f"{cli_s:.1f}s, loss {losses}; peak_bytes_in_use={peak_bytes()}")
    check(ok, "fast gradients disagree with jax.grad of the XLA wavefront")
    check(falls, f"cli inverse loss did not fall: {losses}")
    return {"fast_s": f_best, "xla_s": x_best, "paths": paths,
            "config": f"{width}x{height}x{spp}spp depth {depth}"}


@jax.custom_vjp
def onehot_gather_rows(tbl, idx):
    """tbl[idx] whose transpose is a one-hot matmul instead of XLA's
    scatter-add: three exact bf16 limbs of the cotangent against an exact
    0/1 one-hot, f32 accumulation (the candidate the decision times)."""
    return tbl[idx]


def _onehot_fwd(tbl, idx):
    return tbl[idx], (idx, tbl.shape[0])


def _onehot_bwd(saved, g):
    idx, rows = saved
    onehot = (idx[:, None] == jnp.arange(rows, dtype=idx.dtype)[None, :]
              ).astype(jnp.bfloat16)
    acc = 0.0
    rest = g
    for _ in range(3):  # hi, mid, lo: each exactly bf16-representable
        bits = jax.lax.bitcast_convert_type(rest, jnp.int32)
        limb = jax.lax.bitcast_convert_type(bits & np.int32(~0xFFFF),
                                            jnp.float32)
        rest = rest - limb
        acc = acc + jnp.dot(onehot.T, limb.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
    return acc, None


onehot_gather_rows.defvjp(_onehot_fwd, _onehot_bwd)


def matmul_dot_planes(d, o, c):
    """`core.geometry.dot_planes` as two K=3 matmuls at HIGHEST precision
    (true f32; the candidate the decision times)."""
    highest = jax.lax.Precision.HIGHEST
    return (jnp.matmul(d, c.T, precision=highest),
            jnp.matmul(o, c.T, precision=highest))


def decisions_phase(fwd, grad, width=400, height=300, spp=16, depth=8,
                    plane_width=1200, plane_height=800, plane_spp=8,
                    grid=11, interpret=False):
    """Print both timings of each kernel decision."""
    from bevy_raytrace_tpu.core import geometry
    from bevy_raytrace_tpu.inverse import fast_grad, make_fast_renderer
    from bevy_raytrace_tpu.wavefront.render import render

    log(f"decision forward ({fwd['config']}): triton kernel "
        f"{fwd['kernel_s'] * 1e3:.2f} ms = {fwd['kernel_rps']:,.0f} rays/s "
        f"vs xla wavefront {fwd['xla_s'] * 1e3:.2f} ms = "
        f"{fwd['xla_rps']:,.0f} rays/s")
    scene, cam_fn = flagship_scene(grid)

    pcfg = xla_config(plane_width, plane_height, plane_spp, depth)
    pcam = cam_fn(pcfg.aspect)
    plain_planes = geometry.dot_planes
    times = {}
    for name, planes in (("elementwise", plain_planes),
                         ("matmul", matmul_dot_planes)):
        geometry.dot_planes = planes
        try:
            fn = jax.jit(lambda s, c: render(s, c, pcfg, 0))
            _, times[name], _ = timed(fn, scene, pcam)
        finally:
            geometry.dot_planes = plain_planes
    rays = pcfg.rays_per_frame
    log(f"decision xla intersection planes ({plane_width}x{plane_height}x"
        f"{plane_spp}spp depth {depth} xla forward): elementwise "
        f"{times['elementwise'] * 1e3:.2f} ms = "
        f"{rays / times['elementwise']:,.0f} rays/s vs HIGHEST matmul "
        f"{times['matmul'] * 1e3:.2f} ms = {rays / times['matmul']:,.0f} "
        f"rays/s")

    cfg = xla_config(width, height, spp, depth)
    cam = cam_fn(cfg.aspect)
    plain = fast_grad.gather_rows
    fast_grad.gather_rows = onehot_gather_rows
    try:
        step = _centers_step(make_fast_renderer(cfg, interpret=interpret),
                             scene, cam)
        _, onehot_s, (_, g) = timed(step, scene.centers)
    finally:
        fast_grad.gather_rows = plain
    check(np.isfinite(np.asarray(g)).all(), "one-hot gradient not finite")
    log(f"decision gather transpose ({grad['config']} fast gradient step): "
        f"scatter-add {grad['fast_s']:.3f}s = "
        f"{grad['paths'] / grad['fast_s']:,.0f} paths/s vs one-hot matmul "
        f"{onehot_s:.3f}s = {grad['paths'] / onehot_s:,.0f} paths/s; "
        f"peak_bytes_in_use={peak_bytes()}")
    return {"onehot_s": onehot_s, **times}


def gpu_tests_phase():
    """`pytest -m gpu` in this process (the conftest leaves the GPU be)."""
    import pytest

    os.environ["BRT_TESTS_ON_DEVICE"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    log(f"gpu tests: pytest -m gpu exit {int(rc)} in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"peak_bytes_in_use={peak_bytes()}")
    check(int(rc) == 0, f"pytest -m gpu failed with exit code {int(rc)}")


def four_phase(width=1200, height=800, spp=8, depth=8, grad_width=400,
               grad_height=300, grad_spp=16, grid=11, devices=None,
               interpret=False):
    """Sharded render + sharded fast gradient on the mesh of `devices`.
    Each backend's sharded image is compared with its single-device image
    (RNG keys on absolute pixel ids) and, through the parity gate, with
    the single-device XLA render."""
    from bevy_raytrace_tpu.inverse import (
        make_fast_renderer,
        make_fast_renderer_sharded,
    )
    from bevy_raytrace_tpu.kernels import render_pallas
    from bevy_raytrace_tpu.shard import make_mesh, render_sharded
    from bevy_raytrace_tpu.wavefront.render import render

    devices = jax.devices() if devices is None else devices
    n = len(devices)
    mesh = make_mesh(devices)
    scene, cam_fn = flagship_scene(grid)
    cfg = xla_config(width, height, spp, depth)
    cam = cam_fn(cfg.aspect)
    singles = {
        "pallas": jax.jit(lambda s, c: render_pallas(s, c, cfg, 0,
                                                     interpret=interpret)),
        "xla": jax.jit(lambda s, c: render(s, c, cfg, 0)),
    }
    single_s, single_imgs, results = {}, {}, {}
    for backend, single in singles.items():
        _, single_s[backend], img_1 = timed(single, scene, cam)
        single_imgs[backend] = np.asarray(img_1)
    for backend in singles:
        fn = jax.jit(lambda s, c, b=backend: render_sharded(
            s, c, cfg, mesh, 0, backend=b, interpret=interpret))
        _, best, img = timed(fn, scene, cam)
        owners = {sh.device for sh in img.addressable_shards}
        rows = sorted(sh.index[0].start or 0 for sh in img.addressable_shards)
        check(len(owners) == n and len(img.addressable_shards) == n,
              f"{backend}: stripes on {len(owners)} devices, expected {n}")
        check(rows == [i * height // n for i in range(n)],
              f"{backend}: stripe rows {rows}")
        arr = np.asarray(img)
        exact = bool(np.array_equal(arr, single_imgs[backend]))
        ok, med, bad, bias = parity_gate(arr, single_imgs["xla"])
        results[backend] = (single_s[backend], best, exact, med, bad, bias)
        # The kernel's per-pixel program is the same at any stripe, so its
        # stripes compose bit for bit; XLA may fuse a stripe-shaped
        # wavefront differently, so it must at least pass the gate.
        check(exact or (backend == "xla" and ok),
              f"sharded {backend} image differs from its single-device "
              f"image")
        check(ok, f"sharded {backend} image fails the parity gate "
                  f"against the single-device XLA render")

    gcfg = xla_config(grad_width, grad_height, grad_spp, depth)
    gcam = cam_fn(gcfg.aspect)
    w = jnp.asarray(np.sin(np.arange(gcfg.num_pixels * 3, dtype=np.float32)
                           * 0.37).reshape(grad_height, grad_width, 3) + 0.25)

    def grads(render_fn):
        def loss(centers, albedo):
            mats = dataclasses.replace(scene.materials, albedo=albedo)
            sc = dataclasses.replace(scene, centers=centers, materials=mats)
            return jnp.sum(render_fn(sc, gcam, 1) * w)
        return jax.jit(jax.grad(loss, argnums=(0, 1)))

    one = make_fast_renderer(gcfg, interpret=interpret)
    shd = make_fast_renderer_sharded(gcfg, mesh, interpret=interpret)
    args = (scene.centers, scene.materials.albedo)
    _, g1_s, g1 = timed(grads(one), *args)
    _, gn_s, gn = timed(grads(shd), *args)
    img_eq = bool(np.array_equal(np.asarray(jax.jit(shd)(scene, gcam, 1)),
                                 np.asarray(jax.jit(one)(scene, gcam, 1))))
    worst = 0.0
    for a, b in zip(gn, g1):
        a, b = np.asarray(a), np.asarray(b)
        check(np.isfinite(a).all(), "non-finite sharded cotangents")
        scale = np.abs(b).max() + 1e-8
        # f32 psum/atomic summation order: rtol 1e-4, atol 1e-5 x max|g|.
        excess = np.abs(a - b) - (1e-4 * np.abs(b) + 1e-5 * scale)
        worst = max(worst, float(excess.max()))
    pk = max((peak_bytes(d) or 0) for d in devices)
    stripes = "; ".join(
        f"{b}: single {r[0]:.3f}s, sharded {r[1]:.3f}s, bit-exact {r[2]}, "
        f"vs single xla median {r[3]:.2e} frac>{GATE_BAD_TOL} {r[4]:.4f} "
        f"bias {r[5]:.2e}" for b, r in results.items())
    log(f"four: {n} devices {sorted(str(d) for d in devices)}; "
        f"{width}x{height}x{spp}spp render: {stripes}; fast grad "
        f"{grad_width}x{grad_height}x{grad_spp}spp: single {g1_s:.3f}s, "
        f"sharded {gn_s:.3f}s, image bit-exact {img_eq}, cotangent excess "
        f"over tolerance {worst:.3e}; max peak_bytes_in_use={pk}")
    check(img_eq, "sharded fast image differs from the single-device one")
    check(worst <= 0.0, "sharded cotangents exceed the psum-order tolerance")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded phase")
    args = p.parse_args(argv)

    from bevy_raytrace_tpu.utils.compile_cache import enable_compile_cache

    devices = device_phase()
    enable_compile_cache()
    if args.four:
        if len(devices) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
        four_phase(devices=devices[:4])
        print(last_line(devices[:4]))
        return
    fwd = forward_phase()
    reference_phase()
    grad = gradient_phase()
    decisions_phase(fwd, grad)
    gpu_tests_phase()
    print(last_line(devices))


if __name__ == "__main__":
    main()
