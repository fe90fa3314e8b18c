#!/usr/bin/env python
"""Benchmark harness: rays/s on one GPU.

HEADLINE (value): camera rays (paths) per second on the BASELINE.json
flagship — RTiOW final scene (~486 spheres, defocus camera) at 1200x800,
256 spp, depth 8.  `vs_baseline` divides by the reference's implied rate
at its card-typical 60 FPS: 2,073,600 rays/frame x 60 = 124.4M rays/s
(`src/ray_trace_rays.rs:50`; BASELINE.md: the reference publishes no
numbers).

NAMED FIELDS: the reference's own frame (1920x1080, depth 3, the
197-sphere reference scene variant; `reference_workload_rays_per_s`) and
gradient-step throughput (`grad_*`; the reference has no gradients).

Backends (--backend):
  pallas — the fused GPU trace kernel (`kernels/trace_gpu.py`).
  xla    — the differentiable jnp wavefront (`wavefront/render.py`).

Unless --no-verify, a compiled parity gate runs first: a small config is
rendered by the kernel and by the XLA wavefront and cross-checked
(median error, flipped-pixel fraction, mean bias — see VERIFY_* below),
so a wrong-image-fast-kernel regression fails the bench.

Needs a GPU: with none it exits non-zero and prints no result.  Prints
ONE JSON line to stdout, naming the device it ran on:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N,
     "gpu_name": ..., "power_limit_w": N, ...}

Usage:
    python bench.py                 # full run (flagship + reference + grads)
    python bench.py --quick         # flagship at 16 spp (same rays/s)
    python bench.py --backend pallas|xla
Diagnostics go to stderr; stdout carries exactly the one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REFERENCE_IMPLIED_RAYS_PER_SEC = 2_073_600 * 60.0  # see module docstring

# Compiled-parity gate config: small enough that its compiles dominate
# its cost, big enough to cover every material + defocus blur.
VERIFY_W, VERIFY_H, VERIFY_SPP, VERIFY_DEPTH = 240, 160, 8, 8
# Compiled-vs-compiled tolerances.  Compiled backends legally differ in
# fma contraction and in the GPU's approximate sqrt/rsqrt, which flips
# borderline DISCRETE path choices (hit-vs-miss at tangency, argmin
# near-ties, Schlick Bernoulli at the threshold) on rare pixels; each
# flip swaps in a different-but-valid Monte-Carlo sample with O(1/spp)
# pixel impact.  A genuinely wrong kernel (broken gather / material /
# RNG) misses all three bounds by orders of magnitude.
VERIFY_MEDIAN = 1e-5      # typical pixel must match to f32 noise
VERIFY_BAD_FRAC = 0.02    # pixels allowed to differ > 1e-2 (flipped paths)
VERIFY_BAD_TOL = 1e-2
VERIFY_MEAN_BIAS = 5e-4   # |mean(a - b)| over the image: flips are noise,
                          # a systematic error is a bug


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parity(got, ref):
    """Compiled-vs-compiled image agreement -> (ok, median, bad, bias)."""
    d = np.asarray(got) - np.asarray(ref)
    err = np.abs(d).max(axis=-1)
    med = float(np.median(err))
    bad = float((err > VERIFY_BAD_TOL).mean())
    bias = float(np.abs(d.mean(axis=(0, 1))).max())
    ok = bool(np.isfinite(err).all() and med <= VERIFY_MEDIAN
              and bad <= VERIFY_BAD_FRAC and bias <= VERIFY_MEAN_BIAS)
    return ok, med, bad, bias


def make_render_fn(backend):
    """backend name -> uncompiled render(scene, camera, config, frame)."""
    if backend == "pallas":
        from bevy_raytrace_tpu.kernels import render_pallas

        return render_pallas
    from bevy_raytrace_tpu.wavefront.render import render

    return render


def run_verify(scene, camera_fn):
    """Compiled kernel-vs-XLA parity on a small config -> "pass" (or
    exits non-zero)."""
    import jax

    from bevy_raytrace_tpu import RenderConfig

    cfg = RenderConfig(
        width=VERIFY_W, height=VERIFY_H, samples_per_pixel=VERIFY_SPP,
        max_depth=VERIFY_DEPTH, spp_chunk=VERIFY_SPP,
    )
    camera = camera_fn(cfg.aspect)
    images = {}
    for backend in ("xla", "pallas"):
        fn = jax.jit(make_render_fn(backend), static_argnums=2)
        images[backend] = np.asarray(fn(scene, camera, cfg, 0))
    ok, med, bad, bias = parity(images["pallas"], images["xla"])
    log(f"verify: pallas vs xla: median={med:.2e} "
        f"frac>{VERIFY_BAD_TOL}={bad:.4f} mean_bias={bias:.2e} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("VERIFY FAILED: pallas disagrees with xla")
    return "pass"


def time_call(fn, *args, repeats=2):
    """(first call seconds incl. compile, best of `repeats` warm calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, min(times)


def run_grad_bench(scene, camera_fn):
    """Gradient-step throughput, paths/s for one value_and_grad step:
    `grad_fast` (kernel record + XLA replay) and `grad_xla` (jax.grad of
    the wavefront) at 400x300x16 spp, and `grad_flagship` (the fast path
    on the full 1200x800 x 256 spp flagship frame)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu.inverse import make_fast_renderer
    from bevy_raytrace_tpu.wavefront.render import render

    def step(render_fn, camera):
        def loss(centers):
            sc = dataclasses.replace(scene, centers=centers)
            return jnp.mean(render_fn(sc, camera, 1) ** 2)
        return jax.jit(jax.value_and_grad(loss))

    cfg = RenderConfig(width=400, height=300, samples_per_pixel=16,
                       max_depth=8, spp_chunk=4)
    cam = camera_fn(cfg.aspect)
    big = RenderConfig(width=1200, height=800, samples_per_pixel=256,
                       max_depth=8, spp_chunk=4)
    cam_big = camera_fn(big.aspect)
    cells = {
        "fast": (cfg, step(make_fast_renderer(cfg), cam)),
        "xla": (cfg, step(lambda s, c, f: render(s, c, cfg, f), cam)),
        "flagship": (big, step(make_fast_renderer(big), cam_big)),
    }
    out = {}
    for name, (c, fn) in cells.items():
        _, best = time_call(fn, scene.centers)
        pps = c.rays_per_frame / best
        out[f"grad_{name}_paths_per_s"] = pps
        log(f"grad bench ({name}): {best:.3f}s/step, {pps:,.0f} paths/s "
            f"fwd+bwd ({c.width}x{c.height}x{c.samples_per_pixel}spp)")
    out["grad_fast_speedup"] = (out["grad_fast_paths_per_s"]
                                / out["grad_xla_paths_per_s"])
    return out


def run_reference_workload(backend, spp=256):
    """rays/s on the reference's own frame: its scene variant (14x14
    grid, no dielectrics, ~197 spheres), 1920x1080, 3 bounce rounds
    (`src/lib.rs:25`, `src/ray_trace_node.rs:213-217`)."""
    import jax

    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu.scenes import reference_scene, rtiow_final_camera

    cfg = RenderConfig(width=1920, height=1080, samples_per_pixel=spp,
                       max_depth=3, spp_chunk=4, ray_chunk=103_680)
    scene, _ = reference_scene(seed=0)
    cam = rtiow_final_camera(cfg.aspect)
    fn = jax.jit(make_render_fn(backend), static_argnums=2)
    _, best = time_call(lambda: fn(scene, cam, cfg, 1))
    rps = cfg.rays_per_frame / best
    log(f"reference-equivalent workload (1920x1080x{spp}spp depth 3, "
        f"{scene.count} spheres): {best:.3f}s/frame -> {rps / 1e6:.1f}M "
        f"rays/s")
    return {"reference_workload_rays_per_s": rps}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--quick", action="store_true", help="16 spp variant")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--backend", choices=["xla", "pallas"], default="pallas")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the compiled kernel-vs-XLA parity gate")
    p.add_argument("--no-grad", action="store_true",
                   help="skip the gradient-step throughput measurement")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of one timed frame "
                        "to DIR (open with XProf/Perfetto)")
    args = p.parse_args()
    if args.quick:
        args.spp = 16

    import jax

    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu.scenes import rtiow_final_camera, rtiow_final_scene
    from bevy_raytrace_tpu.utils.compile_cache import enable_compile_cache
    from bevy_raytrace_tpu.utils.device import (
        device_record,
        gpu_info,
        power_limit_watts,
        require_gpu,
    )

    try:
        devices = require_gpu()
    except RuntimeError as e:
        raise SystemExit(f"bench.py measures a GPU: {e}")
    enable_compile_cache()
    dev = device_record(devices)
    smi, cards = gpu_info()
    log(f"devices: {dev}; nvidia-smi: {smi}")

    config = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_depth=args.depth, spp_chunk=min(args.spp, 4),
        ray_chunk=120_000 if args.width * args.height % 120_000 == 0 else 0,
    )
    scene, _ = rtiow_final_scene(seed=0)
    camera = rtiow_final_camera(config.aspect)
    log(f"config: {args.width}x{args.height} x {args.spp}spp depth "
        f"{args.depth}, {scene.count} spheres, backend={args.backend}")

    verify = "skipped"
    if not args.no_verify and args.backend == "pallas":
        verify = run_verify(scene, rtiow_final_camera)
    fields = {}
    if not args.no_grad:
        fields.update(run_grad_bench(scene, rtiow_final_camera))
    fields.update(run_reference_workload(args.backend))

    step = jax.jit(make_render_fn(args.backend), static_argnums=2)
    first, frame_time = time_call(
        lambda: step(scene, camera, config, 2), repeats=args.repeats)
    log(f"compile + first frame: {first:.1f}s")
    if args.trace:
        from bevy_raytrace_tpu.utils.metrics import trace_profile

        with trace_profile(args.trace):
            jax.block_until_ready(step(scene, camera, config, 3))
        log(f"frame trace captured to {args.trace}")

    img = np.asarray(step(scene, camera, config, 2))
    rays_per_sec = config.rays_per_frame / frame_time
    log(f"flagship frame_time={frame_time:.3f}s rays/s={rays_per_sec:,.0f} "
        f"mean_pixel={float(img.mean()):.4f}")
    if not np.isfinite(img).all():
        raise SystemExit("non-finite flagship image")
    print(json.dumps({
        "metric": (f"camera rays (paths)/sec, RTiOW final scene "
                   f"{args.width}x{args.height}x{args.spp}spp depth "
                   f"{args.depth}, backend={args.backend}"),
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / REFERENCE_IMPLIED_RAYS_PER_SEC,
        "verify": verify,
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "gpu_name": cards[0][0],
        "power_limit_w": power_limit_watts(cards[0][1]),
        **fields,
    }))


if __name__ == "__main__":
    main()
