"""Ray-sphere intersection unit tests against hand-computed cases,
mirroring `intersect.wgsl:94-143` behavior (SURVEY.md §4 item 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from bevy_raytrace_tpu.core.geometry import intersect_scene
from bevy_raytrace_tpu.core.types import Ray, make_scene

T_MIN, T_MAX = 1e-3, 1e20


def _scene(centers, radii, mats=None):
    n = len(radii)
    mats = mats if mats is not None else np.zeros(n, np.int32)
    return make_scene(
        centers, radii, mats,
        albedo=np.ones((max(np.max(mats) + 1, 1), 3), np.float32),
        kind=np.zeros(max(np.max(mats) + 1, 1), np.int32),
        fuzz=np.zeros(max(np.max(mats) + 1, 1), np.float32),
        ior=np.ones(max(np.max(mats) + 1, 1), np.float32),
    )


def _shoot(scene, origins, dirs):
    r = Ray(jnp.asarray(origins, jnp.float32), jnp.asarray(dirs, jnp.float32))
    return intersect_scene(r, scene, T_MIN, T_MAX)


def test_head_on_hit():
    s = _scene([[0, 0, -2]], [0.5])
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t[0]), 1.5, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(h.point)[0], [0, 0, -1.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(h.normal)[0], [0, 0, 1], atol=1e-6)
    assert bool(h.front_face[0])


def test_miss():
    s = _scene([[0, 0, -2]], [0.5])
    h = _shoot(s, [[0, 0, 0]], [[0, 1, 0]])
    assert not bool(h.hit[0])
    assert float(h.t[0]) == float(np.float32(T_MAX))


def test_inside_sphere_back_face():
    """Origin inside the sphere: near root is behind t_min -> far root,
    front_face false, normal flipped inward (intersect.wgsl:108-127)."""
    s = _scene([[0, 0, 0]], [1.0])
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    assert bool(h.hit[0])
    np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-6)
    assert not bool(h.front_face[0])
    np.testing.assert_allclose(np.asarray(h.normal)[0], [0, 0, 1], atol=1e-6)


def test_negative_radius_flips_normal():
    """RTiOW hollow-glass trick: negative radius -> inward outward-normal,
    so a ray from outside sees front_face False."""
    s = _scene([[0, 0, -2]], [-0.5])
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    assert bool(h.hit[0])
    assert not bool(h.front_face[0])
    np.testing.assert_allclose(np.asarray(h.normal)[0], [0, 0, 1], atol=1e-6)


def test_nearest_of_two():
    s = _scene([[0, 0, -5], [0, 0, -2]], [0.5, 0.5], np.array([0, 0], np.int32))
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    np.testing.assert_allclose(float(h.t[0]), 1.5, rtol=1e-6)
    assert int(h.material[0]) == 0


def test_material_id_carried():
    s = _scene([[0, 0, -5], [0, 0, -2]], [0.5, 0.5], np.array([1, 2], np.int32))
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    assert int(h.material[0]) == 2


def test_t_min_clipping():
    """A hit closer than t_min is rejected (shadow-acne epsilon,
    EPSILON=0.001 in every reference shader)."""
    s = _scene([[0, 0, -1]], [1.0])
    # Origin on the sphere surface pointing away: near root ~0, far < 0.
    h = _shoot(s, [[0, 0, 0]], [[0, 0, 1]])
    assert not bool(h.hit[0])


def test_tangent_ray_misses():
    """disc == 0 grazing ray: reference requires disc > 0 (intersect.wgsl:103)."""
    s = _scene([[0, 1, -2]], [1.0])
    h = _shoot(s, [[0, 0, 0]], [[0, 0, -1]])
    # Tangent: disc == 0 exactly in exact math; in f32 this is borderline,
    # just require no NaN and a consistent mask/t.
    t = float(h.t[0])
    assert np.isfinite(t)
    assert bool(h.hit[0]) == (t < T_MAX)


def test_oblique_hit_against_quadratic():
    rng = np.random.default_rng(0)
    center = np.array([0.3, -0.2, -3.0])
    radius = 0.7
    s = _scene([center], [radius])
    o = np.array([0.1, 0.2, 0.5])
    d = np.array([-0.05, -0.1, -1.0])
    d = d / np.linalg.norm(d)
    h = _shoot(s, [o], [d])
    oc = o - center
    a = d @ d
    hb = oc @ d
    c = oc @ oc - radius**2
    t_expect = (-hb - np.sqrt(hb * hb - a * c)) / a
    np.testing.assert_allclose(float(h.t[0]), t_expect, rtol=1e-5)
    p = o + t_expect * d
    np.testing.assert_allclose(np.asarray(h.point)[0], p, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(h.normal)[0], (p - center) / radius, atol=1e-5
    )
    del rng


def test_batched_rays():
    s = _scene([[0, 0, -2]], [0.5])
    h = _shoot(s, [[0, 0, 0], [10, 0, 0]], [[0, 0, -1], [0, 0, -1]])
    assert bool(h.hit[0]) and not bool(h.hit[1])


def test_gather_rows_transpose_matches_scatter_add():
    """gather_rows' transpose is XLA's scatter-add: it must equal the VJP
    of plain indexing.  On the GPU the scatter-add runs as atomics, whose
    f32 summation order varies from run to run; the tolerance is that
    order's (~110 unit-scale contributions per row)."""
    import jax
    import jax.numpy as jnp

    from bevy_raytrace_tpu.core.geometry import gather_rows

    rng = np.random.default_rng(3)
    tbl = jnp.asarray(rng.standard_normal((37, 11)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 37, size=4096), jnp.int32)
    w = jnp.asarray(rng.standard_normal((4096, 11)), jnp.float32)

    g_rows = jax.vjp(lambda t: gather_rows(t, idx), tbl)[1](w)[0]
    g_ref = jax.vjp(lambda t: t[idx], tbl)[1](w)[0]
    ref64 = np.zeros((37, 11))
    np.add.at(ref64, np.asarray(idx), np.asarray(w, np.float64))
    np.testing.assert_allclose(np.asarray(g_rows), np.asarray(g_ref),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(g_rows), ref64, rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("n_rays,n_spheres", [(64, 5), (257, 486)])
def test_dot_planes_are_true_f32(n_rays, n_spheres):
    """The intersection's [R, N] inner-product planes are full f32 (a
    TF32 product would be off by ~1e-3 relative), at the RTiOW scene's
    magnitudes: unit directions, origins and centers up to ~1000."""
    from bevy_raytrace_tpu.core.geometry import dot_planes

    rng = np.random.default_rng(5)
    d = rng.standard_normal((n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-15, 15, (n_rays, 3))
    c = rng.uniform(-1000, 1000, (n_spheres, 3))
    d_c, o_c = dot_planes(*(jnp.asarray(x, jnp.float32) for x in (d, o, c)))
    assert d_c.shape == o_c.shape == (n_rays, n_spheres)
    for got, ref in ((d_c, d @ c.T), (o_c, o @ c.T)):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                                   atol=2e-6 * scale)
