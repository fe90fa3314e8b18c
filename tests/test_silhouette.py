"""Silhouette (visibility) gradient quality: measured bounds.

`RenderConfig.edge_softness > 0` adds a TWO-SIDED straight-through
boundary term at the hit sphere's silhouette (wavefront/render.py): the
soft visibility blends the surface radiance with a background estimate —
the runner-up hit's one-bounce shade (albedo2 * sky) when the edge
occludes geometry, the sky itself otherwise (the r3 one-sided
sky-completion form measurably flipped the gradient sign against
occluders; see test_silhouette_gradient_against_occluder's history).

These tests QUANTIFY the envelope against central finite differences of
the hard (edge_softness=0) render — the ground truth, since the RNG is
counter-based and both FD evaluations replay identical sample decisions:

  * sky-background edge: sign correct, magnitude within ~3x
    (measured on this fixture: g_fd ~ -0.027, g_ad ~ -0.0093);
  * occluded edge: sign correct, same envelope (measured: g_fd ~ -0.43,
    g_ad ~ -0.15 — the r3 one-sided term gave +0.035 here).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bevy_raytrace_tpu import RenderConfig
from bevy_raytrace_tpu.core.camera import Camera
from bevy_raytrace_tpu.scenes.builders import _build
from bevy_raytrace_tpu.scenes.registry import MaterialRegistry
from bevy_raytrace_tpu.wavefront.render import render

CFG_SOFT = RenderConfig(width=64, height=32, samples_per_pixel=32,
                        max_depth=3, edge_softness=0.02)
CFG_HARD = dataclasses.replace(CFG_SOFT, edge_softness=0.0)
CAM = Camera.look_at(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0),
                     vfov_deg=40.0, aspect=2.0, aperture=0.0)


def _grad_and_fd(scene, sphere_idx, window, eps=0.01):
    """d(window mean)/d(center_x) by AD (soft) and central FD (hard)."""

    def loss(theta, cfg):
        sc = dataclasses.replace(
            scene, centers=scene.centers.at[sphere_idx, 0].add(theta))
        img = render(sc, CAM, cfg, 0)
        return jnp.mean(img[window[0], window[1], :])

    lf = jax.jit(loss, static_argnums=1)
    g_ad = float(jax.jit(jax.grad(loss), static_argnums=1)(0.0, CFG_SOFT))
    g_fd = (float(lf(eps, CFG_HARD)) - float(lf(-eps, CFG_HARD))) / (2 * eps)
    return g_ad, g_fd


def test_silhouette_gradient_against_sky():
    """Edge over sky: the regime the one-sided term is built for."""
    reg = MaterialRegistry()
    g = reg.lambertian("ground", (0.5, 0.5, 0.5))
    ma = reg.lambertian("front", (0.8, 0.3, 0.1))
    scene = _build([
        ((0.0, -100.5, -1.0), 100.0, g),
        ((0.35, 0.35, -1.0), 0.25, ma),  # floats against the sky
    ], reg)
    g_ad, g_fd = _grad_and_fd(scene, 1, (slice(0, 16), slice(32, 48)))
    assert np.sign(g_ad) == np.sign(g_fd), (g_ad, g_fd)
    ratio = abs(g_ad) / abs(g_fd)
    # Measured 2026-08: ratio ~ 0.34 (the soft edge integrates the jump
    # over its sigmoid width; exactness is not claimed, usable descent
    # direction is).  Bound the envelope so regressions surface.
    assert 0.15 < ratio < 3.0, (g_ad, g_fd)


def test_silhouette_gradient_against_occluder():
    """Edge over another sphere: the TWO-SIDED boundary term (r4) uses
    the runner-up hit's one-bounce shade as the background estimate, so
    the gradient now tracks finite differences against occluders too.

    History: the r3 one-sided (sky-completion) term measured g_ad ~ +0.035
    against g_fd ~ -0.43 on this fixture — wrong sign, ~12x too small —
    and the r3 version of this test pinned that bias.  Two-sided measured
    2026-08-21: g_ad ~ -0.151, ratio 0.35 — the same envelope as the
    sky-background case."""
    reg = MaterialRegistry()
    g = reg.lambertian("ground", (0.5, 0.5, 0.5))
    mb = reg.lambertian("back", (0.1, 0.2, 0.7))
    ma = reg.lambertian("front", (0.8, 0.3, 0.1))
    scene = _build([
        ((0.0, -100.5, -1.0), 100.0, g),
        ((0.0, 0.0, -2.0), 0.6, mb),      # occluded sphere behind
        ((0.35, 0.05, -1.0), 0.25, ma),   # edge lies over B, not sky
    ], reg)
    g_ad, g_fd = _grad_and_fd(scene, 2, (slice(8, 24), slice(30, 52)))
    assert abs(g_fd) > 0.2, f"fixture lost its occluded edge (g_fd={g_fd})"
    assert np.sign(g_ad) == np.sign(g_fd), (g_ad, g_fd)
    ratio = abs(g_ad) / abs(g_fd)
    assert 0.15 < ratio < 3.0, (g_ad, g_fd)


def test_edge_softness_zero_off_silhouette_unbiased():
    """Interior (non-silhouette) gradients are unaffected by the edge
    term: soft and hard AD agree where visibility is locally constant."""
    reg = MaterialRegistry()
    g = reg.lambertian("ground", (0.5, 0.5, 0.5))
    ma = reg.lambertian("front", (0.8, 0.3, 0.1))
    scene = _build([
        ((0.0, -100.5, -1.0), 100.0, g),
        ((0.0, 0.1, -1.0), 0.45, ma),
    ], reg)

    def loss(alb, cfg):
        mats = dataclasses.replace(
            scene.materials,
            albedo=scene.materials.albedo.at[1, 0].set(alb))
        sc = dataclasses.replace(scene, materials=mats)
        img = render(sc, CAM, cfg, 0)
        return jnp.mean(img)

    g_soft = float(jax.jit(jax.grad(loss), static_argnums=1)(0.8, CFG_SOFT))
    g_hard = float(jax.jit(jax.grad(loss), static_argnums=1)(0.8, CFG_HARD))
    np.testing.assert_allclose(g_soft, g_hard, rtol=1e-3)


def test_silhouette_gradient_against_metal_occluder():
    """Edge over a METAL sphere: the `albedo2 * sky`
    background estimate is roughest on non-Lambertian backgrounds; for
    metal it remains a usable proxy because a mirror over this scene
    mostly reflects sky.  Measured 2026-08-21: polished g_ad -0.068 vs
    g_fd -0.382 (ratio 0.18); fuzz=0.4 g_ad -0.076 vs g_fd -0.374
    (ratio 0.20).  Sign correct, same envelope as the Lambertian case."""
    for fuzz in (0.0, 0.4):
        reg = MaterialRegistry()
        g = reg.lambertian("ground", (0.5, 0.5, 0.5))
        mb = reg.metallic("back", (0.8, 0.7, 0.3), fuzz)
        ma = reg.lambertian("front", (0.8, 0.3, 0.1))
        scene = _build([
            ((0.0, -100.5, -1.0), 100.0, g),
            ((0.0, 0.0, -2.0), 0.6, mb),
            ((0.35, 0.05, -1.0), 0.25, ma),
        ], reg)
        g_ad, g_fd = _grad_and_fd(scene, 2, (slice(8, 24), slice(30, 52)))
        assert abs(g_fd) > 0.2, f"fixture lost its edge (g_fd={g_fd})"
        assert np.sign(g_ad) == np.sign(g_fd), (fuzz, g_ad, g_fd)
        ratio = abs(g_ad) / abs(g_fd)
        assert 0.1 < ratio < 3.0, (fuzz, g_ad, g_fd)


def test_silhouette_gradient_against_dielectric_occluder_known_bias():
    """Edge over a DIELECTRIC sphere: the boundary estimate's DOCUMENTED
    failure mode.  A glass runner-up stores albedo
    (1,1,1), so `albedo2 * sky` degenerates to the sky — but the true
    revealed radiance is the darker REFRACTED scene behind the glass
    (here: the gray ground), which one recorded bounce cannot see.
    Measured 2026-08-21: g_ad +0.033 vs g_fd -0.230 — wrong sign, ~7x
    too small, the same failure shape the one-sided estimate had against
    any occluder (r3).  Fixing it would need a second-bounce residual
    through the runner-up (a recorded transmission chain), which is out
    of proportion for an O(edge_softness) correction term; the envelope
    is documented in RenderConfig.edge_softness instead.  This test pins
    the measured bias so an (intentional) estimator change surfaces."""
    reg = MaterialRegistry()
    g = reg.lambertian("ground", (0.5, 0.5, 0.5))
    mb = reg.dielectric("back", 1.5)
    ma = reg.lambertian("front", (0.8, 0.3, 0.1))
    scene = _build([
        ((0.0, -100.5, -1.0), 100.0, g),
        ((0.0, 0.0, -2.0), 0.6, mb),
        ((0.35, 0.05, -1.0), 0.25, ma),
    ], reg)
    g_ad, g_fd = _grad_and_fd(scene, 2, (slice(8, 24), slice(30, 52)))
    assert g_fd < -0.2, f"fixture lost its edge (g_fd={g_fd})"
    # The known bias: small magnitude, possibly wrong sign.  What must
    # NOT happen is a large-magnitude wrong-sign gradient (that would
    # actively fight descent at scale).
    assert abs(g_ad) < 0.5 * abs(g_fd), (g_ad, g_fd)
