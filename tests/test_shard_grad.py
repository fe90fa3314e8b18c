"""Sharded fast gradients (inverse/shard_grad.py) on the virtual 8-device
CPU mesh.

Contracts:
  1. the sharded forward image is bit-identical to the single-device
     recording forward's (RNG keys on absolute pixel ids via the traced
     pixel_base operand);
  2. scene + camera cotangents from the per-stripe replays, psum'd over
     the mesh, match the single-device fast path to f32 summation-order
     tolerance — at more than one mesh shape;
  3. the composition holds for the wavefront recorder and with
     edge_softness (runner-up residuals recorded per stripe).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from bevy_raytrace_tpu import RenderConfig
from bevy_raytrace_tpu.inverse import (
    make_fast_renderer,
    make_fast_renderer_sharded,
)
from bevy_raytrace_tpu.scenes import (
    baseline_config2_camera,
    baseline_config2_scene,
)

CFG = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=3)


def _mesh(hosts, chips):
    devs = np.array(jax.devices("cpu")[: hosts * chips]).reshape(hosts, chips)
    return Mesh(devs, ("hosts", "chips"))


def _probe_weights(cfg):
    n = cfg.height * cfg.width * 3
    w = np.sin(np.arange(n, dtype=np.float32) * 0.37) + 0.25
    return jnp.asarray(w.reshape(cfg.height, cfg.width, 3))


def _loss_grads(render_fn, scene, camera, cfg):
    w = _probe_weights(cfg)

    def loss(centers, albedo):
        mats = dataclasses.replace(scene.materials, albedo=albedo)
        sc = dataclasses.replace(scene, centers=centers, materials=mats)
        return jnp.sum(render_fn(sc, camera, 1) * w)

    return jax.grad(loss, argnums=(0, 1))(scene.centers,
                                          scene.materials.albedo)


def _check_mesh_shape(hosts, chips, cfg=CFG, forward="pallas"):
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(cfg.aspect)
    mesh = _mesh(hosts, chips)
    single = make_fast_renderer(cfg, forward=forward, interpret=True)
    sharded = make_fast_renderer_sharded(cfg, mesh, forward=forward,
                                         interpret=True)

    img_1 = np.asarray(single(scene, cam, 1))
    img_n = np.asarray(sharded(scene, cam, 1))
    np.testing.assert_array_equal(img_n, img_1)

    g1 = _loss_grads(single, scene, cam, cfg)
    gn = _loss_grads(sharded, scene, cam, cfg)
    for a, b, name in ((gn[0], g1[0], "centers"), (gn[1], g1[1], "albedo")):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), f"{name}: non-finite sharded grads"
        scale = np.abs(b).max() + 1e-8
        # psum reorders the f32 accumulation across stripes.
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"{name} cotangent diverges")


def test_sharded_fast_grad_8_devices():
    _check_mesh_shape(2, 4)


def test_sharded_fast_grad_other_mesh_shape():
    _check_mesh_shape(4, 2)


def test_sharded_fast_grad_xla_recorder():
    """The wavefront recorder records and replays per stripe too."""
    _check_mesh_shape(2, 4, forward="xla")


def test_sharded_fast_grad_edge_softness():
    """Two-sided silhouette term: runner-up residuals per stripe."""
    cfg = dataclasses.replace(CFG, edge_softness=0.01)
    _check_mesh_shape(2, 4, cfg=cfg)


def test_sharded_fast_grad_under_jit():
    """The training-step shape: jitted value_and_grad through the
    sharded fast renderer."""
    scene, _ = baseline_config2_scene()
    cam = baseline_config2_camera(CFG.aspect)
    mesh = _mesh(2, 4)
    sharded = make_fast_renderer_sharded(CFG, mesh, interpret=True)

    @jax.jit
    def step(centers):
        sc = dataclasses.replace(scene, centers=centers)
        return jnp.mean(sharded(sc, cam, 1) ** 2)

    loss, g = jax.value_and_grad(step)(scene.centers)
    assert np.isfinite(float(loss))
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0
