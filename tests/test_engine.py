"""Renderer session tests (the frame-loop layer, wavefront/engine.py)."""

import numpy as np
import pytest

from bevy_raytrace_tpu import RenderConfig
from bevy_raytrace_tpu.scenes import baseline_config1_camera, baseline_config1_scene
from bevy_raytrace_tpu.shard import make_mesh
from bevy_raytrace_tpu.utils.metrics import FrameTimer
from bevy_raytrace_tpu.wavefront import Renderer

CFG = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)


def _scene_cam():
    scene, _ = baseline_config1_scene()
    return scene, baseline_config1_camera(CFG.aspect)


def test_warmup_and_frames_advance():
    scene, cam = _scene_cam()
    r = Renderer(CFG, backend="xla")
    assert not r.ready
    dt = r.warmup(scene, cam)
    assert r.ready and dt > 0
    a = np.asarray(r.render_frame(scene, cam))
    b = np.asarray(r.render_frame(scene, cam))
    assert a.shape == (16, 32, 3)
    assert np.abs(a - b).max() > 1e-4  # frame counter advanced -> new noise


def test_warmup_async_nonblocking():
    """The reference compiles pipelines asynchronously and idles in
    Loading until ready (`src/ray_trace_node.rs:173-193`); warmup_async
    is that analog: the caller's thread stays free, `ready` flips on
    completion, and the subsequent frame reuses the warmed jit cache."""
    scene, cam = _scene_cam()
    r = Renderer(CFG, backend="xla")
    assert not r.ready
    fut = r.warmup_async(scene, cam)
    # A second call while one is pending must share the future, not race
    # two compilations.
    assert r.warmup_async(scene, cam) is fut
    dt = fut.result(timeout=120)  # Loading -> Ready
    assert r.ready and dt > 0
    img = np.asarray(r.render_frame(scene, cam))
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()


def test_backends_agree():
    scene, cam = _scene_cam()
    imgs = {}
    for backend in ("xla", "sharded"):
        r = Renderer(CFG, backend=backend,
                     mesh=make_mesh(hosts=2) if backend == "sharded" else None)
        imgs[backend] = np.asarray(r.render_frame(scene, cam))
    np.testing.assert_array_equal(imgs["xla"], imgs["sharded"])


def test_live_scene_edit_no_recompile():
    import dataclasses

    scene, cam = _scene_cam()
    r = Renderer(CFG, backend="xla")
    timer = FrameTimer(CFG, scene.count)
    r.render_frame(scene, cam, timer)  # compile
    n_compiled = r._step._cache_size()
    moved = dataclasses.replace(scene, centers=scene.centers + 0.01)
    img, m = timer.time_frame(r._step, moved, cam, CFG, r.frame)
    # An edited scene must NOT trigger recompilation (traced pytree arg) —
    # the reference pays a per-frame re-upload instead (sphere.rs:180-197).
    assert r._step._cache_size() == n_compiled
    assert m.rays_per_sec > 0
    assert np.abs(np.asarray(img)).max() > 0


@pytest.mark.parametrize("backend", ["cuda", "mxu", "mxu-sharded"])
def test_unknown_backend(backend):
    """Unknown backends (including retired kernel names) fail with the
    list of valid backends."""
    with pytest.raises(ValueError, match="xla, pallas, sharded"):
        Renderer(CFG, backend=backend)


def test_renderer_kernel_backends_interpret():
    """The pallas Renderer wiring runs in CI via the interpreter."""
    scene, cam = _scene_cam()
    ref = np.asarray(Renderer(CFG, backend="xla").render_frame(scene, cam))
    r = Renderer(CFG, backend="pallas", interpret=True)
    img = np.asarray(r.render_frame(scene, cam))
    assert img.shape == ref.shape
    err = np.abs(img - ref).max(axis=-1)
    assert np.median(err) < 1e-6
    assert (err > 1e-3).mean() < 0.005


def test_renderer_pallas_no_recompile_on_scene_edit():
    """Moving spheres must not recompile the kernel: the scene is a
    traced argument."""
    import dataclasses

    scene, cam = _scene_cam()
    r = Renderer(CFG, backend="pallas", interpret=True)
    r.render_frame(scene, cam)
    n_compiled = r._step._cache_size()
    moved = dataclasses.replace(scene, centers=scene.centers + 0.25)
    img = np.asarray(r.render_frame(moved, cam))
    assert r._step._cache_size() == n_compiled
    assert np.isfinite(img).all()


def test_renderer_pallas_off_gpu_needs_interpret():
    """No silent interpreter: the compiled kernel refuses the CPU."""
    scene, cam = _scene_cam()
    with pytest.raises(ValueError, match="interpret"):
        Renderer(CFG, backend="pallas").render_frame(scene, cam)
