"""The fused trace kernel (kernels/trace_gpu.py) against the XLA wavefront,
in the Pallas interpreter on the CPU; the same comparisons run compiled on
the card in tests/test_gpu.py and chip_smoke.py.

SURVEY.md §5 race detection: pure-functional JAX removes data races by
construction; for the kernel the discipline is interpreter equivalence
against the jnp reference path — these tests.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bevy_raytrace_tpu import RenderConfig
from bevy_raytrace_tpu.kernels import render_pallas
from bevy_raytrace_tpu.kernels.trace_gpu import kernel_table
from bevy_raytrace_tpu.scenes import (
    baseline_config1_camera,
    baseline_config1_scene,
    baseline_config2_camera,
    baseline_config2_scene,
    reference_scene,
    rtiow_final_camera,
    rtiow_final_scene,
)
from bevy_raytrace_tpu.wavefront.render import render, render_record

SCENES = {
    "config1": (baseline_config1_scene, baseline_config1_camera),
    "config2": (baseline_config2_scene, baseline_config2_camera),
    "rtiow": (lambda: rtiow_final_scene(seed=3, grid=2), rtiow_final_camera),
    "reference": (lambda: reference_scene(seed=0), rtiow_final_camera),
}


def _scene(name, cfg):
    scene_fn, cam_fn = SCENES[name]
    return scene_fn()[0], cam_fn(cfg.aspect)


def _xla(scene, cam, cfg, frame=0):
    return np.asarray(jax.jit(render, static_argnums=2)(scene, cam, cfg,
                                                        frame))


def _compare(got, ref, tol=1e-4, bad_frac=0.0005):
    assert got.shape == ref.shape
    err = np.abs(ref - got).max(axis=-1)
    # f32 transcendental codegen differs; allow tiny drift, no structure.
    assert np.median(err) < 1e-6
    assert (err > tol).mean() <= bad_frac, (
        f"{(err > tol).mean():.5%} pixels deviate > {tol} (max {err.max()})"
    )


def _gate(got, ref):
    """bench.py's parity gate: rounding differences flip rare discrete
    path choices (mirror chains amplify them); a wrong kernel misses all
    three bounds by orders of magnitude."""
    assert got.shape == ref.shape
    d = got.astype(np.float64) - ref
    err = np.abs(d).max(axis=-1)
    assert np.median(err) <= 1e-5
    assert (err > 1e-2).mean() <= 0.02
    assert np.abs(d.reshape(-1, 3).mean(axis=0)).max() <= 5e-4


def _check(name, width, height, spp, depth):
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=depth)
    scene, cam = _scene(name, cfg)
    got = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    _compare(got, _xla(scene, cam, cfg))


def test_pallas_matches_xla_config1():
    _check("config1", 64, 32, 2, 3)


def test_pallas_matches_xla_all_materials():
    _check("config2", 64, 32, 2, 4)


def test_pallas_matches_xla_defocus_scene():
    _check("rtiow", 64, 32, 2, 3)


def test_pallas_nonaligned_resolution():
    """Resolution not a multiple of the pixel block: padded lanes must
    not corrupt real pixels."""
    _check("config1", 50, 30, 2, 2)


@pytest.mark.parametrize("name", ["config1", "config2", "rtiow", "reference"])
@pytest.mark.parametrize("size", [(48, 32), (37, 23)])
def test_kernel_passes_parity_gate(name, size):
    """Every scene, at a block-aligned and an odd resolution (the padded
    tail of the last block is masked)."""
    cfg = RenderConfig(width=size[0], height=size[1], samples_per_pixel=2,
                       max_depth=3)
    scene, cam = _scene(name, cfg)
    got = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    _gate(got, _xla(scene, cam, cfg))


def test_depth_zero_is_black():
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=0)
    scene, cam = _scene("config1", cfg)
    img = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    assert img.shape == (8, 16, 3) and not img.any()


def test_pallas_spp_accumulation():
    """The in-program sample loop averages like the XLA path."""
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=8, max_depth=2)
    scene, cam = _scene("config1", cfg)
    got = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    np.testing.assert_allclose(got, _xla(scene, cam, cfg), atol=2e-4)


def test_sample_base_splits_samples():
    """Samples [0, 4) == the mean of samples [0, 2) and [2, 4)."""
    cfg = RenderConfig(width=24, height=16, samples_per_pixel=4, max_depth=3)
    half = dataclasses.replace(cfg, samples_per_pixel=2)
    scene, cam = _scene("config2", cfg)
    full = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    a = np.asarray(render_pallas(scene, cam, half, interpret=True))
    b = np.asarray(render_pallas(scene, cam, half, interpret=True,
                                 sample_base=2))
    np.testing.assert_allclose(full, (a + b) / 2, atol=1e-6)


def test_pallas_frame_seed():
    cfg = RenderConfig(width=64, height=32, samples_per_pixel=1, max_depth=2)
    scene, cam = _scene("config1", cfg)
    a = np.asarray(render_pallas(scene, cam, cfg, 0, interpret=True))
    b = np.asarray(render_pallas(scene, cam, cfg, 1, interpret=True))
    assert np.abs(a - b).max() > 1e-3
    err = np.abs(_xla(scene, cam, cfg, 1) - b).max(axis=-1)
    assert np.median(err) < 1e-6


@pytest.mark.parametrize("block,num_warps", [(32, 1), (64, 2), (256, 8)])
def test_block_shape_does_not_change_pixels(block, num_warps):
    cfg = RenderConfig(width=40, height=20, samples_per_pixel=2, max_depth=3)
    scene, cam = _scene("config2", cfg)
    ref = np.asarray(render_pallas(scene, cam, cfg, interpret=True))
    got = np.asarray(render_pallas(scene, cam, cfg, interpret=True,
                                   block=block, num_warps=num_warps))
    np.testing.assert_array_equal(got, ref)


def test_block_must_be_power_of_two():
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=1)
    scene, cam = _scene("config1", cfg)
    with pytest.raises(ValueError, match="power of two"):
        render_pallas(scene, cam, cfg, interpret=True, block=96)


@pytest.mark.parametrize("name", ["config2", "rtiow"])
@pytest.mark.parametrize("softness", [0.0, 0.01])
def test_residuals_match_xla_recorder(name, softness):
    """Winner (and, with edge_softness, runner-up) residuals: int16
    [spp, depth, P], equal to the XLA recorder's."""
    cfg = RenderConfig(width=32, height=24, samples_per_pixel=2, max_depth=4,
                       edge_softness=softness)
    scene, cam = _scene(name, cfg)
    second = softness > 0
    got = render_pallas(scene, cam, cfg, interpret=True, with_residuals=True,
                        record_second=second)
    ref = jax.jit(render_record, static_argnums=2)(scene, cam, cfg)
    assert len(got) == len(ref) == (3 if second else 2)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == jnp.int16 and b.dtype == jnp.int16
        assert a.shape == (2, 4, cfg.num_pixels)
        # share of (sample, bounce, pixel) slots whose winner differs
        assert (np.asarray(a) != np.asarray(b)).mean() <= 0.005
    assert (np.asarray(got[1]) >= -1).all()
    assert (np.asarray(got[1]) < scene.count).all()


def test_record_second_requires_residuals():
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=1)
    scene, cam = _scene("config1", cfg)
    with pytest.raises(ValueError, match="with_residuals"):
        render_pallas(scene, cam, cfg, interpret=True, record_second=True)


@pytest.mark.parametrize("n_stripes", [2, 4, 8])
def test_stripes_compose(n_stripes):
    """Stripe mode: image and residual stripes equal the corresponding
    slices of the full render (RNG keys on absolute pixel ids)."""
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=3)
    scene, cam = _scene("config2", cfg)
    img, res = render_pallas(scene, cam, cfg, interpret=True,
                             with_residuals=True)
    flat = np.asarray(img).reshape(-1, 3)
    local = cfg.num_pixels // n_stripes
    for k in range(n_stripes):
        base = k * local
        img_s, res_s = render_pallas(
            scene, cam, cfg, interpret=True, with_residuals=True,
            pixel_base=jnp.uint32(base), num_local=local)
        np.testing.assert_array_equal(np.asarray(img_s),
                                      flat[base:base + local])
        np.testing.assert_array_equal(np.asarray(res_s),
                                      np.asarray(res)[:, :, base:base + local])


def test_compiled_call_off_gpu_names_interpret():
    """No silent interpreter: off the GPU the kernel raises an error that
    says how to ask for the interpreter."""
    cfg = RenderConfig(width=16, height=8, samples_per_pixel=1, max_depth=1)
    scene, cam = _scene("config1", cfg)
    with pytest.raises(ValueError, match="interpret=True"):
        render_pallas(scene, cam, cfg)


def test_kernel_table_rows():
    scene, _ = baseline_config2_scene()
    tbl = np.asarray(kernel_table(scene))
    c = np.asarray(scene.centers)
    r = np.asarray(scene.radii)
    assert tbl.shape == (scene.count, 11)
    np.testing.assert_allclose(tbl[:, :3], c)
    np.testing.assert_allclose(tbl[:, 3], (c * c).sum(-1) - r * r, rtol=1e-6)
    np.testing.assert_allclose(tbl[:, 4], 1.0 / r, rtol=1e-6)
    kinds = np.asarray(scene.materials.kind)[np.asarray(scene.material_id)]
    np.testing.assert_array_equal(tbl[:, 8], kinds)
