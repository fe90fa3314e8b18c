"""Renderer session object — the frame-loop layer.

The reference drives frames through a render-graph node with a
Loading -> Ready state machine gated on async pipeline compilation
(`src/ray_trace_node.rs:173-193`) and re-uploads scene/camera buffers
every frame (`src/sphere.rs:180-197`).  Here `Renderer` holds
the jitted step (compilation happens on `warmup()` or the first frame —
the Loading phase), auto-advances the frame counter (RNG decorrelation,
like the reference's `frame` bump in `ray_trace_globals.rs:56-68`), and
accepts a new scene/camera pytree every frame for free.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Optional

import jax

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.utils.metrics import FrameTimer


BACKENDS = ("xla", "pallas", "sharded")


class Renderer:
    """A reusable render session.

    Args:
      config: static render configuration.
      backend: "xla" (the differentiable wavefront), "pallas" (the fused
        GPU trace kernel, forward-only), or "sharded" (pixels over a
        device mesh, the wavefront per stripe).
      mesh: the mesh for backend="sharded" (default: all devices).
      interpret: run the pallas backend in the Pallas interpreter (CPU
        tests); never chosen implicitly.
    """

    def __init__(self, config: RenderConfig, backend: str = "xla", mesh=None,
                 interpret: bool = False):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; valid backends: "
                f"{', '.join(BACKENDS)}")
        self.config = config
        self.backend = backend
        self.interpret = interpret
        self.frame = 0
        self.ready = False
        self._compile_time: Optional[float] = None
        self._warmup_lock = threading.Lock()
        self._extra = (config,)

        if backend == "xla":
            from bevy_raytrace_tpu.wavefront.render import render

            self._step = jax.jit(render, static_argnums=2)
        elif backend == "pallas":
            from bevy_raytrace_tpu.kernels.trace_gpu import render_pallas

            self._step = jax.jit(
                functools.partial(render_pallas, interpret=interpret),
                static_argnums=2)
        else:
            from bevy_raytrace_tpu.shard import make_mesh, render_sharded

            self._step = jax.jit(render_sharded, static_argnums=(2, 3))
            self._extra = (config, make_mesh() if mesh is None else mesh)

    def warmup(self, scene, camera):
        """Compile (the reference's Loading phase); returns compile seconds."""
        t0 = time.perf_counter()
        jax.block_until_ready(self._step(scene, camera, *self._extra, 0))
        self._compile_time = time.perf_counter() - t0
        self.ready = True
        return self._compile_time

    def warmup_async(self, scene, camera):
        """Non-blocking compile — the reference's async pipeline build
        (`src/ray_trace_pipeline.rs:49-59`: shaders compile in the
        background while the app stays responsive, and the frame node
        idles in Loading until ready, `src/ray_trace_node.rs:173-193`).

        Returns a `concurrent.futures.Future` resolving to the compile
        seconds; `self.ready` flips when compilation finishes.  Callers
        may keep doing host-side work (scene edits, IO) meanwhile and
        either poll `ready` or call `render_frame` directly (which then
        waits on the same jit cache instead of recompiling).

        The compile runs on a DAEMON thread (an early interpreter exit
        must not block on a minutes-long compile), and repeated
        calls while one is pending return the same future rather than
        racing two compilations (the pending-check and assignment are
        under a lock)."""
        import concurrent.futures

        with self._warmup_lock:
            pending = getattr(self, "_warmup_future", None)
            if pending is not None and not pending.done():
                return pending
            fut = concurrent.futures.Future()
            self._warmup_future = fut

        def run():
            try:
                fut.set_result(self.warmup(scene, camera))
            except BaseException as e:  # noqa: BLE001 — routed to future
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="brt-warmup").start()
        return fut

    def render_frame(self, scene, camera, timer: Optional[FrameTimer] = None):
        """Render the next frame (frame counter auto-advances)."""
        if timer is not None:
            img, _ = timer.time_frame(
                self._step, scene, camera, *self._extra, self.frame
            )
        else:
            img = self._step(scene, camera, *self._extra, self.frame)
        self.frame += 1
        self.ready = True
        return img
