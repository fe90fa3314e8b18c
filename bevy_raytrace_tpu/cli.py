"""Command-line entry points (the reference's L0 app layer, headless).

The reference's `entry()` builds a windowed interactive app
(`src/lib.rs:28-48`: 1920x1080 borderless window, WASD fly camera, ESC to
quit).  This renderer is headless: the window/input layer is replaced by
CLI rendering with image writeback (SURVEY.md §7 checklist item 7), and
the live-editable camera becomes the `--lookfrom/--lookat` flags plus the
animate subcommand (per-frame camera updates through the same jitted step,
the analog of the per-frame re-upload path).

Usage:
    python -m bevy_raytrace_tpu.cli render  --scene rtiow -o out.png
    python -m bevy_raytrace_tpu.cli render  --scene reference --width 1920 \
        --height 1080 --spp 1 --depth 3 -o frame.png
    python -m bevy_raytrace_tpu.cli animate --frames 24 -o frames/
    python -m bevy_raytrace_tpu.cli serve   --spp 4    # live fly-camera viewer
    python -m bevy_raytrace_tpu.cli inverse --steps 200 -o recovered.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _add_render_args(p):
    p.add_argument("--scene", default="rtiow",
                   choices=["config1", "config2", "rtiow", "reference"])
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--spp-chunk", type=int, default=0)
    p.add_argument("--ray-chunk", type=int, default=0)
    p.add_argument("--lookfrom", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--vfov", type=float, default=None)
    p.add_argument("--aperture", type=float, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over all local devices")
    p.add_argument("--backend", choices=["xla", "pallas"], default="xla",
                   help="compute path (xla = the differentiable wavefront; "
                        "pallas = the fused GPU trace kernel)")
    p.add_argument("--interpret", action="store_true",
                   help="run the pallas backend in the Pallas interpreter "
                        "(CPU debugging)")
    p.add_argument("-o", "--output", default="render.png")


def _build(args):
    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu import scenes

    spp_chunk = args.spp_chunk or (1 if args.spp == 1 else
                                   min(4, args.spp))
    while args.spp % spp_chunk:
        spp_chunk -= 1
    config = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_depth=args.depth, seed=args.seed, spp_chunk=spp_chunk,
        ray_chunk=args.ray_chunk,
    )
    builders = {
        "config1": (scenes.baseline_config1_scene, scenes.baseline_config1_camera),
        "config2": (scenes.baseline_config2_scene, scenes.baseline_config2_camera),
        "rtiow": (lambda: scenes.rtiow_final_scene(args.seed),
                  scenes.rtiow_final_camera),
        "reference": (lambda: scenes.reference_scene(args.seed),
                      scenes.rtiow_final_camera),
    }
    scene_fn, cam_fn = builders[args.scene]
    scene, registry = scene_fn()
    camera = cam_fn(config.aspect)
    if any(v is not None for v in (args.lookfrom, args.lookat, args.vfov,
                                   args.aperture)):
        from bevy_raytrace_tpu.core.camera import Camera

        camera = Camera.look_at(
            lookfrom=args.lookfrom or (13.0, 2.0, 3.0),
            lookat=args.lookat or (0.0, 0.0, 0.0),
            vfov_deg=args.vfov if args.vfov is not None else 20.0,
            aspect=config.aspect,
            aperture=args.aperture if args.aperture is not None else 0.0,
        )
    return config, scene, camera, registry


def _make_step(config, args):
    import functools

    import jax

    backend = getattr(args, "backend", "xla")
    interpret = getattr(args, "interpret", False)
    if args.sharded:
        from bevy_raytrace_tpu.shard import make_mesh, render_sharded

        mesh = make_mesh()
        print(f"mesh: {mesh}", file=sys.stderr)
        fn = functools.partial(render_sharded, backend=backend,
                               interpret=interpret)
        return jax.jit(fn, static_argnums=(2, 3)), (config, mesh)
    if backend == "pallas":
        from bevy_raytrace_tpu.kernels import render_pallas

        fn = functools.partial(render_pallas, interpret=interpret)
        return jax.jit(fn, static_argnums=2), (config,)
    from bevy_raytrace_tpu.wavefront.render import render

    return jax.jit(render, static_argnums=2), (config,)


def cmd_render(args):
    from bevy_raytrace_tpu.io import write_image

    config, scene, camera, _ = _build(args)
    step, extra = _make_step(config, args)
    # PNG/PPM quantize to 8 bits anyway: tone-map on DEVICE and ship 3
    # bytes/pixel over the D2H link instead of 12 (see cmd_animate's
    # note; EXR keeps the linear floats).
    to_u8 = os.path.splitext(args.output)[1].lower() != ".exr"
    t0 = time.time()
    # The device-to-host fetch is inside the timed region; the fetched
    # array is what write_image needs anyway.
    out = step(scene, camera, *extra, args.frame)
    if to_u8:
        import jax
        import jax.numpy as jnp

        out = jax.jit(lambda x: (jnp.sqrt(jnp.clip(x, 0.0, 1.0)) * 255.0
                                 + 0.5).astype(jnp.uint8))(out)
    img = np.asarray(out)
    dt = time.time() - t0
    rays = config.rays_per_frame
    print(
        f"rendered {config.width}x{config.height} x {config.samples_per_pixel}spp "
        f"in {dt:.2f}s (compile incl.) — {rays / dt:,.0f} rays/s",
        file=sys.stderr,
    )
    write_image(args.output, np.asarray(img))
    print(args.output)


def cmd_animate(args):
    """Render an orbiting-camera sequence — the headless analog of the
    reference's interactive fly camera (`src/camera.rs:39-77`): the camera
    pytree changes every frame with zero recompilation."""
    from bevy_raytrace_tpu.core.camera import Camera
    from bevy_raytrace_tpu.io import FrameWriter

    import jax
    import jax.numpy as jnp

    config, scene, camera, _ = _build(args)
    step, extra = _make_step(config, args)
    os.makedirs(args.output, exist_ok=True)
    t_first = t_rest = 0.0

    # Device-side tone-map: ship 3 bytes/pixel to the host instead of 12.
    # PNG output quantizes to 8 bits anyway, so nothing is lost.
    @jax.jit
    def _tonemap_u8(img):
        return (jnp.sqrt(jnp.clip(img, 0.0, 1.0)) * 255.0 + 0.5
                ).astype(jnp.uint8)

    # Double-buffered frame loop: dispatch frame i+1 to the device BEFORE
    # downloading frame i, so the D2H transfer rides under the next
    # frame's render; the worker pool (io/writer.py) then encodes and
    # writes off-thread.  Neither the device nor the link ever waits on
    # the other (the reference's presentation path never blocks either;
    # its image never leaves the GPU).
    def orbit_cam(i):
        ang = 2.0 * np.pi * i / args.frames
        return Camera.look_at(
            lookfrom=(13.0 * np.cos(ang), 2.0, 13.0 * np.sin(ang)),
            lookat=(0.0, 0.0, 0.0),
            vfov_deg=20.0,
            aspect=config.aspect,
            aperture=0.1,
            focus_dist=10.0,
        )

    with FrameWriter() as fw:
        t0 = time.time()
        prev = prev_path = None
        for i in range(args.frames):
            u8 = _tonemap_u8(step(scene, orbit_cam(i), *extra, i))
            if i == 0:
                # Sync so the compile cost is attributed to the first frame.
                jax.block_until_ready(u8)
                t_first = time.time() - t0
                t0 = time.time()
            if prev is not None:
                fw.submit(prev_path, np.asarray(prev))
            prev = u8
            prev_path = os.path.join(args.output, f"frame_{i:04d}.png")
        if prev is not None:  # --frames 0 renders nothing
            fw.submit(prev_path, np.asarray(prev))
        t_rest = time.time() - t0
    if args.frames > 1:
        print(
            f"first frame {t_first:.2f}s (compile), then "
            f"{t_rest / (args.frames - 1):.3f}s/frame "
            f"({(args.frames - 1) * config.rays_per_frame / t_rest:,.0f} rays/s)",
            file=sys.stderr,
        )
    print(args.output)


_SERVE_PAGE = """<!DOCTYPE html>
<html><head><title>bevy_raytrace_tpu</title><style>
body {{ background: #111; color: #ccc; font: 13px monospace; margin: 0; }}
#v {{ display: block; margin: 8px auto; image-rendering: pixelated; }}
#hud {{ text-align: center; }}
</style></head><body>
<img id="v" width="{w2}" height="{h2}">
<div id="hud">WASD / arrows: orbit+dolly &nbsp; QE: pitch &nbsp;
Esc: quit server</div>
<script>
let yaw = {yaw}, pitch = {pitch}, dist = {dist}, busy = false, dirty = true;
async function refresh() {{
  if (busy) {{ dirty = true; return; }}
  busy = true; dirty = false;
  const r = await fetch(`/frame.png?yaw=${{yaw}}&pitch=${{pitch}}&dist=${{dist}}`);
  const b = await r.blob();
  document.getElementById('v').src = URL.createObjectURL(b);
  busy = false;
  if (dirty) refresh();
}}
document.addEventListener('keydown', (e) => {{
  const s = 0.15;
  if (e.key === 'a' || e.key === 'ArrowLeft') yaw -= s;
  else if (e.key === 'd' || e.key === 'ArrowRight') yaw += s;
  else if (e.key === 'w' || e.key === 'ArrowUp') dist = Math.max(2, dist - 1);
  else if (e.key === 's' || e.key === 'ArrowDown') dist += 1;
  else if (e.key === 'q') pitch = Math.min(1.3, pitch + s);
  else if (e.key === 'e') pitch = Math.max(-1.3, pitch - s);
  else if (e.key === 'Escape') {{ fetch('/quit', {{method: 'POST'}}); return; }}
  else return;
  refresh();
}});
refresh();
</script></body></html>"""


def cmd_serve(args):
    """Live interactive viewer over HTTP — the headless-compatible analog
    of the reference's windowed session (`src/lib.rs:28-48`): the browser
    page stands in for the presentation sprite
    (`src/ray_trace_output.rs:65-77`), WASD/arrow keys fly the camera
    (`src/camera.rs:39-77`) by re-rendering through the SAME jitted step
    with a new camera pytree (zero recompilation, the per-frame re-upload
    path), and Escape shuts the session down (`src/input.rs:15-26`).

    Endpoints: GET / (viewer page), GET /frame.png?yaw=&pitch=&dist=
    (one rendered frame), POST /quit (ESC).  Requests render through one
    jitted step, so the compiled program is reused across frames exactly
    as in `animate`."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    from bevy_raytrace_tpu.core.camera import Camera
    from bevy_raytrace_tpu.io import png_bytes, tonemap

    config, scene, camera0, _ = _build(args)
    step, extra = _make_step(config, args)
    state = {"frame": int(args.frame)}

    def render_frame(yaw, pitch, dist):
        cam = Camera.look_at(
            lookfrom=(dist * np.cos(pitch) * np.cos(yaw),
                      dist * np.sin(pitch) + 2.0,
                      dist * np.cos(pitch) * np.sin(yaw)),
            lookat=(0.0, 0.0, 0.0), vfov_deg=20.0, aspect=config.aspect,
            aperture=args.aperture if args.aperture is not None else 0.0,
            focus_dist=dist,
        )
        img = step(scene, cam, *extra, state["frame"])
        state["frame"] += 1
        return png_bytes(tonemap(np.asarray(img)))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            print(f"serve: {fmt % a}", file=sys.stderr)

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                page = _SERVE_PAGE.format(
                    w2=config.width * 2, h2=config.height * 2,
                    yaw=0.23, pitch=0.15, dist=13.0)
                self._send(200, "text/html", page.encode())
            elif u.path == "/frame.png":
                q = parse_qs(u.query)

                def f(name, default):
                    try:
                        return float(q[name][0])
                    except (KeyError, ValueError, IndexError):
                        return default

                body = render_frame(f("yaw", 0.23), f("pitch", 0.15),
                                    max(f("dist", 13.0), 1.0))
                self._send(200, "image/png", body)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path == "/quit":
                self._send(200, "text/plain", b"bye")
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
            else:
                self._send(404, "text/plain", b"not found")

    server = HTTPServer((args.host, args.port), Handler)
    print(f"serving on http://{args.host}:{server.server_address[1]}/ "
          f"(Esc in the page, or POST /quit, to stop)", file=sys.stderr)
    print(f"{server.server_address[1]}", flush=True)  # tests read the port
    server.serve_forever()
    server.server_close()


def cmd_inverse(args):
    """BASELINE config 4 demo: perturb the config1 scene, recover it."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bevy_raytrace_tpu.inverse import InverseProblem, optimize
    from bevy_raytrace_tpu.io import write_image
    from bevy_raytrace_tpu.wavefront.render import render

    args.scene = "config1"
    config, scene_true, camera, _ = _build(args)
    opt_config = dataclasses.replace(config, edge_softness=0.01)

    # --backend xla: differentiate the XLA wavefront (sweep paid in both
    # directions).  --backend pallas: the residual-replay fast path — the
    # fused kernel records per-bounce winners, the backward replays them
    # with no sphere sweep (inverse/fast_grad.py).  --sharded composes
    # with both: pixels stripe over the device mesh, scene and camera
    # cotangents psum (the fast form records + replays per stripe —
    # inverse/shard_grad.py).
    render_fn = None
    backend = getattr(args, "backend", "xla")
    interpret = getattr(args, "interpret", False)
    if getattr(args, "sharded", False):
        from bevy_raytrace_tpu.shard import make_mesh

        mesh = make_mesh()
        print(f"mesh: {mesh}", file=sys.stderr)
        if backend == "pallas":
            from bevy_raytrace_tpu.inverse import make_fast_renderer_sharded

            fast = make_fast_renderer_sharded(opt_config, mesh,
                                              interpret=interpret)
            render_fn = lambda sc, cam, cfg, fr: fast(sc, cam, fr)  # noqa: E731
        else:
            from bevy_raytrace_tpu.shard import render_sharded

            render_fn = (lambda sc, cam, cfg, fr:  # noqa: E731
                         render_sharded(sc, cam, cfg, mesh, fr))
    elif backend == "pallas":
        from bevy_raytrace_tpu.inverse import make_fast_renderer

        fast = make_fast_renderer(opt_config, interpret=interpret)
        render_fn = lambda sc, cam, cfg, fr: fast(sc, cam, fr)  # noqa: E731

    target = jax.jit(render, static_argnums=2)(scene_true, camera, config, 9999)
    mats = dataclasses.replace(
        scene_true.materials,
        albedo=scene_true.materials.albedo.at[1].set(
            jnp.array([0.2, 0.8, 0.6], jnp.float32)),
    )
    scene_bad = dataclasses.replace(
        scene_true,
        materials=mats,
        centers=scene_true.centers.at[1].add(
            jnp.array([0.25, -0.1, 0.1], jnp.float32)),
    )
    problem = InverseProblem(config=opt_config, camera=camera, target=target,
                             optimizable=("centers", "albedo"),
                             render_fn=render_fn)
    t0 = time.time()
    result = optimize(
        scene_bad, problem, steps=args.steps, learning_rate=args.lr,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        callback=lambda s, l: print(f"step {s}: loss {l:.5f}", file=sys.stderr)
        if s % 20 == 0 or s == args.steps - 1 else None,
    )
    print(f"optimized {args.steps} steps in {time.time() - t0:.1f}s",
          file=sys.stderr)
    print(f"recovered center: {np.asarray(result.scene.centers)[1]} "
          f"(true {np.asarray(scene_true.centers)[1]})", file=sys.stderr)
    print(f"recovered albedo: {np.asarray(result.scene.materials.albedo)[1]} "
          f"(true {np.asarray(scene_true.materials.albedo)[1]})", file=sys.stderr)
    img = jax.jit(render, static_argnums=2)(result.scene, camera, config, 0)
    write_image(args.output, np.asarray(img))
    print(args.output)


def main(argv=None):
    p = argparse.ArgumentParser(prog="bevy_raytrace_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one frame to an image file")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render an orbit sequence")
    _add_render_args(pa)
    pa.add_argument("--frames", type=int, default=8)
    pa.set_defaults(fn=cmd_animate)

    ps = sub.add_parser(
        "serve", help="live interactive viewer over HTTP (fly camera)")
    _add_render_args(ps)
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=0,
                    help="0 = pick a free port (printed to stdout)")
    ps.set_defaults(fn=cmd_serve)

    pi = sub.add_parser("inverse", help="inverse-rendering recovery demo")
    _add_render_args(pi)
    pi.add_argument("--steps", type=int, default=120)
    pi.add_argument("--lr", type=float, default=1.5e-2)
    pi.add_argument("--checkpoint", default=None)
    pi.add_argument("--checkpoint-every", type=int, default=50)
    pi.set_defaults(fn=cmd_inverse)

    args = p.parse_args(argv)
    from bevy_raytrace_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
