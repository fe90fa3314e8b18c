"""Tiny pytree-dataclass helper.

Registers a frozen dataclass as a JAX pytree via
`jax.tree_util.register_dataclass`, with an optional set of static
(`meta_fields`) attributes that become part of the treedef instead of the
leaves.  This is the struct layer that replaces the reference's hand-packed
GPU-layout structs (`CameraGPU`, `RayGPU`, `SphereGPU`, `MaterialGPU`, ... —
reference `src/ray_trace_camera.rs:14-25`, `src/ray_trace_rays.rs:11-19`,
`src/sphere.rs:12-17`, `src/ray_trace_materials.rs:33-43`): in JAX there is
no std430 layout to maintain, a pytree of arrays is the native currency of
jit/pjit/grad.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple = ()):
    """Decorator: frozen dataclass registered as a JAX pytree.

    `meta_fields` are static (hashable, compared by equality in the treedef);
    all other fields are pytree leaves (arrays / sub-pytrees).
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        ]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta_fields)
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)
