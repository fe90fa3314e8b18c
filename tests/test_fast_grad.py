"""The residual-replay differentiable fast path (inverse/fast_grad.py).

Forward = a recording render (the fused kernel in the Pallas interpreter,
or the XLA wavefront's recorder); backward = differentiable jnp replay of
the recorded paths (no sphere sweep).  Contracts tested here:

  1. the fast renderer's forward image IS the recording forward's image;
  2. the replay itself reconstructs the forward image (the checkpoint is
     complete: winner index + RNG counters determine the path);
  3. its gradients match `jax.grad` through the XLA wavefront — same
     straight-through policy, same sampled paths — for both recorders,
     and with edge_softness off and on.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from bevy_raytrace_tpu import RenderConfig
import pytest

from bevy_raytrace_tpu.inverse import make_fast_renderer, replay_image
from bevy_raytrace_tpu.inverse.fast_grad import replay_pixel_range, scene_table
from bevy_raytrace_tpu.kernels import render_pallas
from bevy_raytrace_tpu.scenes import (
    baseline_config1_camera,
    baseline_config1_scene,
    baseline_config2_camera,
    baseline_config2_scene,
    rtiow_final_camera,
    rtiow_final_scene,
)
from bevy_raytrace_tpu.wavefront.render import render, render_record

CFG = RenderConfig(width=48, height=32, samples_per_pixel=2, max_depth=3)


def _set_params(scene, params):
    mats = dataclasses.replace(
        scene.materials,
        albedo=params.get("albedo", scene.materials.albedo),
        fuzz=params.get("fuzz", scene.materials.fuzz),
        ior=params.get("ior", scene.materials.ior),
    )
    return dataclasses.replace(
        scene,
        centers=params.get("centers", scene.centers),
        radii=params.get("radii", scene.radii),
        materials=mats,
    )


def _probe_weights(cfg):
    # A fixed, structured cotangent image: probes every pixel with varying
    # sign/magnitude so gradient errors cannot cancel in a mean.
    n = cfg.height * cfg.width * 3
    w = np.sin(np.arange(n, dtype=np.float32) * 0.37) + 0.25
    return jnp.asarray(w.reshape(cfg.height, cfg.width, 3))


def _grads(render_fn, scene, cfg, names, frame=0):
    w = _probe_weights(cfg)

    def loss(params):
        img = render_fn(_set_params(scene, params), frame)
        return jnp.sum(img * w)

    params = {n: {"centers": scene.centers, "radii": scene.radii,
                  "albedo": scene.materials.albedo,
                  "fuzz": scene.materials.fuzz,
                  "ior": scene.materials.ior}[n] for n in names}
    return jax.grad(loss)(params)


def _compare_grads(scene, camera, cfg, names, forward="pallas", rtol=5e-3,
                   atol=3e-4):
    fast = make_fast_renderer(cfg, forward=forward, interpret=True)
    g_fast = _grads(lambda s, f: fast(s, camera, f), scene, cfg, names)
    g_xla = _grads(lambda s, f: render(s, camera, cfg, f), scene, cfg, names)
    for n in names:
        a, b = np.asarray(g_fast[n]), np.asarray(g_xla[n])
        assert np.isfinite(a).all(), f"{n}: non-finite fast grads"
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol * scale,
            err_msg=f"param {n}: fast-path grads diverge from XLA path")


def test_fast_forward_is_pallas_forward():
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    fast = make_fast_renderer(CFG, interpret=True)
    got = np.asarray(fast(scene, cam, 0))
    ref = np.asarray(render_pallas(scene, cam, CFG, 0, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_replay_reconstructs_forward_image():
    """The residual checkpoint is complete: replaying winners + RNG
    reproduces the kernel's image (differences are only transcendental
    codegen drift)."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    img, res = render_pallas(scene, cam, CFG, 0, interpret=True,
                             with_residuals=True)
    rep = replay_image(scene, cam, CFG, res, 0)
    np.testing.assert_allclose(np.asarray(rep), np.asarray(img), atol=5e-5)


def test_fast_grads_match_xla_config1():
    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(CFG.aspect)
    _compare_grads(scene, cam, CFG, ("centers", "radii", "albedo"))


def test_fast_grads_match_xla_all_materials():
    """config2: Lambertian + metal + dielectric; fuzz/ior grads flow."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    _compare_grads(scene, cam, CFG, ("albedo", "fuzz", "ior"))


def test_fast_grads_xla_recorder():
    """forward="xla": the wavefront recorder + the same replay backward
    (no kernel at all) matches jax.grad of the wavefront."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    _compare_grads(scene, cam, CFG, ("centers", "albedo"), forward="xla")


def test_fast_grads_edge_softness():
    """The soft-silhouette boundary term is replayed identically."""
    cfg = dataclasses.replace(CFG, edge_softness=0.01)
    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(cfg.aspect)
    _compare_grads(scene, cam, cfg, ("centers", "radii"))


def test_fast_renderer_under_jit_and_value_and_grad():
    """The shape used by inverse/optimize: jitted value_and_grad of a
    scalar loss through the fast renderer."""
    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(CFG.aspect)
    fast = make_fast_renderer(CFG, interpret=True)
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)

    @jax.jit
    def step(centers):
        sc = dataclasses.replace(scene, centers=centers)
        img = fast(sc, cam, 0)
        return jnp.mean((img - target) ** 2)

    loss, g = jax.value_and_grad(step)(scene.centers)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0.0


def test_fast_grads_rtiow_bulk_agreement():
    """The RTiOW final scene (defocus camera, metal+glass at grazing
    angles) exposes the near-tangency pathology: a path with disc -> 0
    has d(t)/d(theta) ~ 1/sqrt(disc), so single grazing samples dominate
    BOTH estimators' gradient norms and are maximally sensitive to
    ulp-level codegen differences (|g_xla|_max is many times its own p99
    — outlier noise, not signal).  The contract that CAN be asserted: the
    replayed fast path matches the XLA path on the BULK of components;
    the outlier tail differs because the two backends resolve tangency
    flips differently, not because a pathway is missing.  The tail
    touches more components as the path count grows, so the trimmed
    ratio rises with it (CPU, XLA recorder: ~0.06 at this size, ~0.14
    at 160x120x16 spp depth 8)."""
    import numpy as _np

    scene, _ = rtiow_final_scene(seed=0)
    cfg = RenderConfig(width=96, height=48, samples_per_pixel=8,
                       max_depth=6, spp_chunk=4)
    cam = rtiow_final_camera(cfg.aspect)
    fast = make_fast_renderer(cfg, interpret=True)

    def lf(c):
        sc = dataclasses.replace(scene, centers=c)
        return jnp.mean(fast(sc, cam, 1) ** 2)

    def lx(c):
        sc = dataclasses.replace(scene, centers=c)
        return jnp.mean(render(sc, cam, cfg, 1) ** 2)

    gf = _np.asarray(jax.grad(lf)(scene.centers)).ravel()
    gx = _np.asarray(jax.grad(lx)(scene.centers)).ravel()
    assert _np.isfinite(gf).all() and _np.isfinite(gx).all()
    d = _np.abs(gf - gx)
    trimmed = _np.sort(d)[: int(0.98 * d.size)]
    scale = _np.percentile(_np.abs(gx), 99)
    assert trimmed.max() < 0.3 * scale, (trimmed.max(), scale)


@pytest.mark.parametrize("softness", [0.0, 0.01])
def test_xla_recorder_replay_reconstructs_image(softness):
    """The wavefront recorder's checkpoint is complete too: its image is
    the plain render's, and replaying it reproduces that image."""
    cfg = dataclasses.replace(CFG, edge_softness=softness)
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(cfg.aspect)
    img, res, *rest = jax.jit(render_record, static_argnums=2)(scene, cam,
                                                               cfg)
    assert res.dtype == jnp.int16
    assert res.shape == (cfg.samples_per_pixel, cfg.max_depth,
                         cfg.num_pixels)
    assert len(rest) == (1 if softness else 0)
    np.testing.assert_array_equal(np.asarray(img),
                                  np.asarray(render(scene, cam, cfg)))
    rep = replay_image(scene, cam, cfg, res, res2=rest[0] if rest else None)
    np.testing.assert_allclose(np.asarray(rep), np.asarray(img), atol=5e-5)


def test_xla_recorder_chunking_is_invisible():
    """spp_chunk / ray_chunk reorder the wavefront batches; the recorded
    residuals come back in [spp, depth, pixel] order regardless."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    cfg = dataclasses.replace(CFG, samples_per_pixel=4, spp_chunk=1)
    chunked = dataclasses.replace(cfg, spp_chunk=2, ray_chunk=384)
    _, a = render_record(scene, cam, cfg)
    _, b = render_record(scene, cam, chunked)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_replay_stripes_compose():
    """replay_pixel_range over two stripes == the whole-frame replay."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    _, res = render_record(scene, cam, CFG)
    tbl = scene_table(scene)
    n = CFG.num_pixels
    full = np.asarray(replay_pixel_range(tbl, cam, CFG, res, 0, n))
    half = n // 2
    for base in (0, half):
        part = replay_pixel_range(tbl, cam, CFG, res[:, :, base:base + half],
                                  jnp.uint32(base), half)
        np.testing.assert_allclose(np.asarray(part), full[base:base + half],
                                   atol=1e-6)


@pytest.mark.parametrize("remat", [True, False])
def test_remat_does_not_change_gradients(remat):
    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(CFG.aspect)
    _, res = render_record(scene, cam, CFG)
    w = _probe_weights(CFG)

    def grad(r):
        return jax.grad(lambda c: jnp.sum(replay_image(
            dataclasses.replace(scene, centers=c), cam, CFG, res,
            remat=r) * w))(scene.centers)

    # Rematerialization only reorders f32 arithmetic.
    np.testing.assert_allclose(np.asarray(grad(remat)),
                               np.asarray(grad(None)), rtol=1e-5, atol=1e-6)


def test_unknown_forward_rejected():
    with pytest.raises(ValueError, match="pallas"):
        make_fast_renderer(CFG, forward="sweep")
