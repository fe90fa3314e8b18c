#!/usr/bin/env python
"""Scaling evidence on a virtual CPU mesh: collective audit, structure
run and profiler trace.  Wall-clock multi-card scaling needs the cards;
what this tool records into SCALING.json is what the compiler decides:

1. **HLO collective audit** (the load-bearing evidence).  The sharded
   render and its gradient step are compiled for an 8-device mesh and
   every collective op in the optimized HLO is counted and sized:
     * forward: ZERO collectives — pixels are sharded, the scene is
       replicated, each device traces its stripe independently.
     * backward: all-reduces totalling a few KB (the psum of replicated
       scene cotangents: ~486 spheres x centers/radii/albedo/fuzz/ior)
       against seconds of per-device compute.
   The partitioned program is the one a multi-device run compiles.

2. **Virtual 8-device run** (structure check): the same program executes
   on a CPU mesh (--xla_force_host_platform_device_count, SURVEY.md §4
   item 4) and produces a correct image at every mesh size.  Wall-clock
   on shared CPU cores is NOT an efficiency signal — times are recorded
   with that caveat attached.

3. **Profiler trace** of the sharded gradient step
   (`utils.metrics.trace_profile`) — open with XProf/Perfetto to see the
   backward-sweep/psum placement.

Usage:
    python tools/scaling.py
    python tools/scaling.py --trace-dir /tmp/brt_trace --out SCALING.json
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import numpy as np  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


_COLLECTIVES = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.-]+\s*=\s*(\S+?)\s+"
    r"(all-reduce|all-gather|all-to-all|collective-permute|"
    r"reduce-scatter|collective-broadcast)\(",
    re.M,
)

_SHAPE_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "f16": 2,
                "s8": 1, "u8": 1, "pred": 1, "f64": 8, "s64": 8, "u64": 8}


def _shape_nbytes(shape: str) -> int:
    """'f32[486,3]{1,0}' -> 5832 bytes (best-effort; tuples split)."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape):
        dt, dims = m.group(1), m.group(2)
        if dt not in _SHAPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _SHAPE_BYTES[dt]
    return total


def audit_collectives(hlo_text: str):
    """All collective ops in an HLO module -> [(op, shape, bytes)]."""
    out = []
    for m in _COLLECTIVES.finditer(hlo_text):
        shape, op = m.group(1), m.group(2)
        out.append({"op": op, "shape": shape,
                    "bytes": _shape_nbytes(shape)})
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=200)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--trace-dir", default="/tmp/brt_trace")
    p.add_argument("--out", default="SCALING.json")
    p.add_argument("--no-multiproc", dest="multiproc", action="store_false",
                   help="skip the real 2-process collective audit")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu.scenes import rtiow_final_camera, rtiow_final_scene
    from bevy_raytrace_tpu.shard import make_mesh, render_sharded
    from bevy_raytrace_tpu.utils.metrics import trace_profile
    from bevy_raytrace_tpu.wavefront.render import render_pixel_range

    devs = jax.devices()
    log(f"platform {jax.default_backend()}, {len(devs)} virtual devices, "
        f"{os.cpu_count()} host cores")

    config = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp, max_depth=args.depth,
        spp_chunk=min(4, args.spp),
    )
    scene, _ = rtiow_final_scene(seed=0)
    camera = rtiow_final_camera(config.aspect)
    paths = config.rays_per_frame

    mesh8 = make_mesh(devs, hosts=1)
    n_dev = len(devs)
    local = config.num_pixels // n_dev

    def grad_loss(centers, frame):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        sc = dataclasses.replace(scene, centers=centers)

        @functools.partial(
            shard_map, mesh=mesh8, in_specs=(P(), P()),
            out_specs=P(("hosts", "chips")), check_vma=False)
        def fwd(sc, cam):
            rank = (jax.lax.axis_index("hosts")
                    * jax.lax.axis_size("chips")
                    + jax.lax.axis_index("chips"))
            return render_pixel_range(
                sc, cam, config, (rank * local).astype("uint32"),
                local, frame)

        img = fwd(sc, camera)
        return (img * img).mean()

    grad_step = jax.jit(jax.grad(grad_loss), static_argnums=1)

    # ---- 1. collective audit of the partitioned programs ---------------
    log("compiling sharded forward + gradient step for the HLO audit ...")
    fwd_hlo = (
        jax.jit(render_sharded, static_argnums=(2, 3))
        .lower(scene, camera, config, mesh8, 0)
        .compile().as_text())
    bwd_hlo = grad_step.lower(scene.centers, 0).compile().as_text()
    fwd_coll = audit_collectives(fwd_hlo)
    bwd_coll = audit_collectives(bwd_hlo)
    fwd_bytes = sum(c["bytes"] for c in fwd_coll)
    bwd_bytes = sum(c["bytes"] for c in bwd_coll)
    log(f"forward collectives: {len(fwd_coll)} ({fwd_bytes} bytes)")
    log(f"backward collectives: {len(bwd_coll)} ({bwd_bytes} bytes): "
        + ", ".join(f"{c['op']} {c['shape']}" for c in bwd_coll[:8]))
    assert not fwd_coll, (
        "sharded forward render must have ZERO collectives — "
        f"found {fwd_coll}")
    assert bwd_bytes < 1 << 20, (
        f"backward collective volume {bwd_bytes} B unexpectedly large")

    # ---- 2. virtual-mesh execution (structure check) -------------------
    results = []
    for n in args.devices:
        if n > len(devs):
            continue
        mesh = make_mesh(devs[:n], hosts=1)
        step = jax.jit(render_sharded, static_argnums=(2, 3))
        img = jax.block_until_ready(step(scene, camera, config, mesh, 0))
        mean = float(np.asarray(img).mean())
        assert np.isfinite(mean) and mean > 0, "bad image"
        times = []
        for i in range(args.repeats):
            t0 = time.time()
            jax.block_until_ready(step(scene, camera, config, mesh, i + 1))
            times.append(time.time() - t0)
        ft = min(times)
        results.append({"devices": n, "frame_s": ft,
                        "rays_per_s": paths / ft, "image_mean": mean})
        log(f"{n} devices: {ft:.3f}s/frame ({paths / ft:,.0f} rays/s) "
            f"[shared-core wall-clock, not an efficiency signal]")

    # ---- 2b. flagship-resolution sharded gradient step -----------------
    # The collective audit and the backward headline describe the same
    # pixel workload: audit + one executed step
    # at 1200x800 on the 8-device mesh; spp is reduced because this is a
    # partitioning/structure check on a 2-core CPU host, and the
    # collective payload (the replicated scene cotangents) is
    # resolution- and spp-independent.
    cfg_flag = RenderConfig(width=1200, height=800, samples_per_pixel=2,
                            max_depth=8, spp_chunk=1, ray_chunk=30000)
    cam_flag = rtiow_final_camera(cfg_flag.aspect)
    local_f = cfg_flag.num_pixels // n_dev

    def grad_loss_flag(centers, frame):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        sc = dataclasses.replace(scene, centers=centers)

        @functools.partial(
            shard_map, mesh=mesh8, in_specs=(P(), P()),
            out_specs=P(("hosts", "chips")), check_vma=False)
        def fwd(sc, cam):
            rank = (jax.lax.axis_index("hosts")
                    * jax.lax.axis_size("chips")
                    + jax.lax.axis_index("chips"))
            return render_pixel_range(
                sc, cam, cfg_flag, (rank * local_f).astype("uint32"),
                local_f, frame)

        img = fwd(sc, cam_flag)
        return (img * img).mean()

    grad_flag = jax.jit(jax.grad(grad_loss_flag), static_argnums=1)
    flag_hlo = grad_flag.lower(scene.centers, 0).compile().as_text()
    flag_coll = audit_collectives(flag_hlo)
    flag_bytes = sum(c["bytes"] for c in flag_coll)
    log(f"flagship (1200x800) grad-step collectives: {len(flag_coll)} "
        f"({flag_bytes} bytes)")
    assert flag_bytes < 1 << 20, flag_coll
    t0 = time.time()
    gflag = jax.block_until_ready(grad_flag(scene.centers, 1))
    flag_s = time.time() - t0
    assert np.isfinite(np.asarray(gflag)).all()
    log(f"flagship sharded grad step executed in {flag_s:.1f}s "
        f"[shared-core wall-clock, structure check only]")

    # ---- 2c. sharded FAST-grad step (record + replay per stripe) ------
    # Audit the partitioned forward (expect ZERO collectives: residuals
    # are recorded per stripe and never leave the device) and the full
    # gradient step (expect the explicit psum of the [S, 11] table
    # cotangent + the camera's 16 scalars — ~21 KB-class), then execute
    # one step on the virtual mesh (interpret-mode kernel) and check
    # finiteness.
    from bevy_raytrace_tpu.inverse import make_fast_renderer_sharded

    cfg_fast = RenderConfig(width=64, height=32, samples_per_pixel=2,
                            max_depth=3)
    cam_fast = rtiow_final_camera(cfg_fast.aspect)
    fast_sharded = make_fast_renderer_sharded(cfg_fast, mesh8,
                                              interpret=True)

    def fast_loss(centers, frame):
        sc = dataclasses.replace(scene, centers=centers)
        img = fast_sharded(sc, cam_fast, frame)
        return (img * img).mean()

    log("compiling sharded fast-grad step for the HLO audit ...")
    # Audit the RENDER forward (sharded image out), not the scalar loss:
    # reducing the sharded image to a scalar legitimately psums once.
    fast_fwd_hlo = (
        jax.jit(lambda c, f: fast_sharded(
            dataclasses.replace(scene, centers=c), cam_fast, f),
            static_argnums=1)
        .lower(scene.centers, 0).compile().as_text())
    fast_grad = jax.jit(jax.grad(fast_loss), static_argnums=1)
    fast_bwd_hlo = fast_grad.lower(scene.centers, 0).compile().as_text()
    fast_fwd_coll = audit_collectives(fast_fwd_hlo)
    fast_bwd_coll = audit_collectives(fast_bwd_hlo)
    fast_bwd_bytes = sum(c["bytes"] for c in fast_bwd_coll)
    log(f"fast-grad forward collectives: {len(fast_fwd_coll)}")
    log(f"fast-grad step collectives: {len(fast_bwd_coll)} "
        f"({fast_bwd_bytes} bytes): "
        + ", ".join(f"{c['op']} {c['shape']}" for c in fast_bwd_coll[:8]))
    assert not fast_fwd_coll, (
        "sharded fast forward (value) must have ZERO collectives — "
        f"found {fast_fwd_coll}")
    assert fast_bwd_coll, "fast-grad step must psum its cotangents"
    assert fast_bwd_bytes < 1 << 20, fast_bwd_coll
    t0 = time.time()
    gfast = jax.block_until_ready(fast_grad(scene.centers, 1))
    fast_s = time.time() - t0
    assert np.isfinite(np.asarray(gfast)).all()
    log(f"sharded fast-grad step executed in {fast_s:.1f}s "
        f"[interpret-mode kernels on the virtual mesh, structure check]")

    # ---- 3. gradient-step profiler trace -------------------------------
    trace_path = None
    if args.trace_dir:
        g = jax.block_until_ready(grad_step(scene.centers, 1))
        with trace_profile(args.trace_dir):
            g = jax.block_until_ready(grad_step(scene.centers, 2))
        assert np.isfinite(np.asarray(g)).all()
        trace_path = args.trace_dir
        log(f"gradient-step trace captured to {trace_path}")

    # ---- 4. REAL 2-process audit (hosts axis spans OS processes) -------
    multiproc = None
    if args.multiproc:
        import re as _re
        import socket
        import subprocess

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(repo, "tools",
                                          "multihost_worker.py"),
             str(pid), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=repo) for pid in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        ok = all(p.returncode == 0 for p in procs) and all(
            "AUDIT ok fwd_collectives=0" in o
            and "GRADRUN ok" in o and "FASTGRAD ok" in o for o in outs)
        bwd_b = None
        m = _re.search(r"bwd_bytes=(\d+)", outs[0])
        if m:
            bwd_b = int(m.group(1))
        multiproc = {"processes": 2, "ok": ok,
                     "forward_collectives": 0 if ok else "FAIL",
                     "backward_bytes": bwd_b}
        log(f"2-process audit: ok={ok} bwd_bytes={bwd_b}")
        assert ok, "multi-process collective audit failed"

    out = {
        "workload": f"{args.width}x{args.height}x{args.spp}spp "
                    f"depth {args.depth}, sharded xla wavefront, "
                    f"{scene.count} spheres",
        "multiprocess_audit": multiproc,
        "flagship_grad_step": {
            "workload": "1200x800x2spp depth 8 (structure check; "
                        "collective payload is spp-independent)",
            "collectives": flag_coll,
            "bytes": flag_bytes,
            "step_s_virtual_cpu": flag_s,
        },
        "fast_grad_step": {
            "workload": "64x32x2spp depth 3, kernel record + XLA replay per "
                        "stripe (inverse/shard_grad.py; collective "
                        "payload is resolution/spp-independent)",
            "forward_collectives": len(fast_fwd_coll),
            "collectives": fast_bwd_coll,
            "bytes": fast_bwd_bytes,
            "step_s_virtual_cpu": fast_s,
        },
        "host": f"cpu-virtual-{len(devs)} on {os.cpu_count()} cores "
                "(wall-clock is a structure check only; see docstring)",
        "forward_collectives": {"count": len(fwd_coll),
                                "bytes": fwd_bytes},
        "backward_collectives": {"count": len(bwd_coll),
                                 "bytes": bwd_bytes,
                                 "ops": bwd_coll},
        "per_step_compute_bytes_per_device": 4 * 3 * local
        * config.samples_per_pixel,
        "results": results,
        "trace": trace_path,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
