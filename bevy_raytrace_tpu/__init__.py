"""bevy_raytrace_tpu — a differentiable wavefront path tracer in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference
`brandon-reinhart/bevy_raytrace` (a Rust/Bevy/wgpu compute-shader wavefront
path tracer implementing "Ray Tracing in One Weekend"): camera ray generation
(pinhole + thin-lens defocus), ray-sphere intersection, Lambertian / metal /
dielectric scattering with Schlick fresnel, sky-gradient miss shading, and
fixed-depth bounce accumulation into a framebuffer — re-designed for an accelerator:

- The reference's six WGSL compute kernels over an atomic-counter ray queue
  (reference `src/ray_trace_node.rs:204-220`) become a pure-functional,
  jit/pjit-able render step: generate -> lax.scan over bounces of
  (intersect -> shade) -> collect, over a dense SoA wavefront with masked
  dead lanes (no compaction, ray index == pixel index, mirroring the
  reference's design, `assets/shaders/intersect.wgsl:154`).
- Stochastic sampling is counter-based / reparameterized (PCG4D hashes of
  (pixel, sample, bounce, seed)) so the same sample sequence replays under
  any sharding and in both forward and backward passes.
- The forward trace also runs as one fused GPU kernel (Pallas through
  Triton, `kernels/trace_gpu.py`): one program per pixel block, every
  sample and bounce in registers.
- Rays/pixels shard across a device mesh via shard_map; the scene is
  replicated (it is tiny), so a bounce needs zero cross-device traffic.
- The renderer is differentiable end-to-end: scene-parameter gradients
  (sphere centers/radii, material albedo/fuzz/IOR, camera) support inverse
  rendering, with one gradient psum over the mesh.

Public API (stable):
    RenderConfig, Camera, Scene, Materials, MaterialRegistry
    render, render_pallas, render_sharded
    scenes.*  (baseline scene builders)
"""

from bevy_raytrace_tpu.config import RenderConfig
from bevy_raytrace_tpu.core.types import Materials, Ray, Scene
from bevy_raytrace_tpu.core.camera import Camera
from bevy_raytrace_tpu.scenes.registry import MaterialRegistry
from bevy_raytrace_tpu.wavefront.render import render

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "Scene",
    "Materials",
    "Ray",
    "MaterialRegistry",
    "render",
    "__version__",
]
