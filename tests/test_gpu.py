"""Card-only tests: the fused kernel compiled for the GPU (no interpreter).

Marked `gpu`; `python chip_smoke.py` runs them on the card with
`pytest -m gpu`.  Whether a card is present is decided inside the fixture,
never at import, so every test worker collects the same tests; without a
GPU they skip.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bevy_raytrace_tpu import RenderConfig
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

pytestmark = pytest.mark.gpu

CFG = RenderConfig(width=96, height=64, samples_per_pixel=4, max_depth=6)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU")
    return jax.devices()[0]


def _gate(got, ref):
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    err = np.abs(d).max(axis=-1)
    assert np.median(err) <= 1e-5
    assert (err > 1e-2).mean() <= 0.02
    assert np.abs(d.reshape(-1, 3).mean(axis=0)).max() <= 5e-4


@pytest.mark.parametrize("name", ["config2", "rtiow"])
def test_compiled_kernel_matches_xla(gpu, name):
    if name == "config2":
        scene, _ = baseline_config2_scene()
        cam = baseline_config2_camera(CFG.aspect)
    else:
        scene, _ = rtiow_final_scene(seed=0)
        cam = rtiow_final_camera(CFG.aspect)
    got = jax.jit(render_pallas, static_argnums=2)(scene, cam, CFG)
    ref = jax.jit(render, static_argnums=2)(scene, cam, CFG)
    _gate(got, ref)


def test_compiled_residuals_match_xla_recorder(gpu):
    cfg = dataclasses.replace(CFG, edge_softness=0.01)
    scene, _ = rtiow_final_scene(seed=0)
    cam = rtiow_final_camera(cfg.aspect)
    _, res, res2 = jax.jit(
        lambda s, c: render_pallas(s, c, cfg, 0, with_residuals=True,
                                   record_second=True))(scene, cam)
    _, ref, ref2 = jax.jit(render_record, static_argnums=2)(scene, cam, cfg)
    assert res.dtype == jnp.int16 and res.shape == ref.shape
    for a, b in ((res, ref), (res2, ref2)):
        differ = (np.asarray(a) != np.asarray(b)).any(axis=1).mean()
        assert differ <= 0.02, differ


def test_compiled_stripes_compose(gpu):
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    full = np.asarray(render_pallas(scene, cam, CFG)).reshape(-1, 3)
    half = CFG.num_pixels // 2
    for base in (0, half):
        part = render_pallas(scene, cam, CFG, pixel_base=jnp.uint32(base),
                             num_local=half)
        np.testing.assert_array_equal(np.asarray(part),
                                      full[base:base + half])


def test_compiled_fast_grad_matches_xla(gpu):
    from bevy_raytrace_tpu.inverse import make_fast_renderer

    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(CFG.aspect)
    fast = make_fast_renderer(CFG)

    def grads(render_fn):
        def loss(centers):
            sc = dataclasses.replace(scene, centers=centers)
            return jnp.mean(render_fn(sc, cam, 1) ** 2)
        return np.asarray(jax.jit(jax.grad(loss))(scene.centers))

    g_fast = grads(fast)
    with jax.default_matmul_precision("highest"):
        g_xla = grads(lambda s, c, f: render(s, c, CFG, f))
    assert np.isfinite(g_fast).all()
    scale = np.abs(g_xla).max() + 1e-8
    np.testing.assert_allclose(g_fast, g_xla, rtol=5e-2, atol=5e-3 * scale)
