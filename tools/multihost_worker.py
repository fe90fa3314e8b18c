"""Worker process for the 2-process jax.distributed CPU test.

Usage: python tools/multihost_worker.py <process_id> <num_processes> <coord>

Each process brings up `initialize_multihost` (the real multi-host
entry, `shard/mesh.py`), contributes 2 virtual CPU devices to a global
("hosts", "chips") mesh, renders its pixel stripes via `render_sharded`,
allgathers, and checks the full image against a locally computed
single-device reference — proving the sharded wavefront is bit-identical
across PROCESS boundaries, not just across virtual devices in one
process.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)
# Pinned to the CPU: on a machine with a GPU, a worker that opened the
# card would compete with its parent process for the card's memory.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from bevy_raytrace_tpu.shard import initialize_multihost

    initialize_multihost(coordinator_address=coord, num_processes=nproc,
                         process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, jax.devices()

    import numpy as np
    from jax.experimental import multihost_utils

    from bevy_raytrace_tpu import RenderConfig
    from bevy_raytrace_tpu.scenes import (
        baseline_config1_camera,
        baseline_config1_scene,
    )
    from bevy_raytrace_tpu.shard import make_mesh, render_sharded
    from bevy_raytrace_tpu.wavefront.render import render

    cfg = RenderConfig(width=64, height=32, samples_per_pixel=2, max_depth=3)
    scene, _ = baseline_config1_scene()
    cam = baseline_config1_camera(cfg.aspect)

    mesh = make_mesh()  # hosts axis = real process count
    assert mesh.devices.shape == (nproc, 2), mesh.devices.shape
    img = render_sharded(scene, cam, cfg, mesh, 0)
    full = np.asarray(multihost_utils.process_allgather(img, tiled=True))

    ref = np.asarray(
        jax.jit(render, static_argnums=2)(scene, cam, cfg, 0))
    if not np.array_equal(full, ref):
        print(f"proc {pid}: MISMATCH max "
              f"{np.abs(full - ref).max()}", flush=True)
        sys.exit(1)
    print(f"proc {pid}: OK bit-exact over {nproc} processes", flush=True)

    # ---- HLO collective audit on the REAL multi-process mesh ----------
    # (The single-process virtual-mesh audit in
    # tools/scaling.py must also hold when the hosts axis spans actual
    # processes — the partitioner sees a different device assignment.)
    import dataclasses
    import functools

    from tools.scaling import audit_collectives
    from bevy_raytrace_tpu.wavefront.render import render_pixel_range

    local = cfg.num_pixels // (2 * nproc)

    def grad_loss(centers, frame):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        sc = dataclasses.replace(scene, centers=centers)

        @functools.partial(
            shard_map, mesh=mesh, in_specs=(P(), P()),
            out_specs=P(("hosts", "chips")), check_vma=False)
        def fwd(sc, cam_):
            rank = (jax.lax.axis_index("hosts")
                    * jax.lax.axis_size("chips")
                    + jax.lax.axis_index("chips"))
            return render_pixel_range(
                sc, cam_, cfg, (rank * local).astype("uint32"),
                local, frame)

        img = fwd(sc, cam)
        return (img * img).mean()

    fwd_hlo = (jax.jit(render_sharded, static_argnums=(2, 3))
               .lower(scene, cam, cfg, mesh, 0).compile().as_text())
    bwd_hlo = (jax.jit(jax.grad(grad_loss), static_argnums=1)
               .lower(scene.centers, 0).compile().as_text())
    fwd_coll = audit_collectives(fwd_hlo)
    bwd_coll = audit_collectives(bwd_hlo)
    bwd_bytes = sum(c["bytes"] for c in bwd_coll)
    if fwd_coll:
        print(f"proc {pid}: AUDIT FAIL forward collectives {fwd_coll}",
              flush=True)
        sys.exit(1)
    if bwd_bytes >= 1 << 20:
        print(f"proc {pid}: AUDIT FAIL backward volume {bwd_bytes} B",
              flush=True)
        sys.exit(1)
    print(f"proc {pid}: AUDIT ok fwd_collectives=0 "
          f"bwd_bytes={bwd_bytes}", flush=True)

    # ---- RUN one gradient step on the real 2-process mesh -------------
    # The psum-reduced cotangent must be finite and IDENTICAL on
    # every process — the all-reduce hands all ranks the same bits.
    g = jax.jit(jax.grad(grad_loss), static_argnums=1)(scene.centers, 1)
    # The cotangent is replicated over a mesh this process only partly
    # addresses: compare each process's LOCAL copy via a host-level
    # gather of the numpy value.
    g_local = np.asarray(g.addressable_data(0))
    if not np.isfinite(g_local).all():
        print(f"proc {pid}: GRADRUN FAIL non-finite cotangents", flush=True)
        sys.exit(1)
    g_all = np.asarray(multihost_utils.process_allgather(g_local))
    for other in range(g_all.shape[0]):
        if not np.array_equal(g_all[other], g_local):
            print(f"proc {pid}: GRADRUN FAIL cotangents differ from "
                  f"process {other} (max "
                  f"{np.abs(g_all[other] - g_local).max()})", flush=True)
            sys.exit(1)
    print(f"proc {pid}: GRADRUN ok |g|={np.abs(g_local).max():.3e} "
          f"psum-consistent over {nproc} processes", flush=True)

    # ---- SHARDED FAST-grad step across real processes ------------------
    # The fast backward — kernel record + XLA replay per stripe,
    # inverse/shard_grad.py — under the 2-process mesh, with the kernel
    # in the Pallas interpreter, where the hosts axis spans OS processes.
    from bevy_raytrace_tpu.inverse import make_fast_renderer_sharded

    fast = make_fast_renderer_sharded(cfg, mesh, interpret=True)

    def fast_loss(centers, frame):
        sc = dataclasses.replace(scene, centers=centers)
        img = fast(sc, cam, frame)
        return (img * img).mean()

    gf = jax.jit(jax.grad(fast_loss), static_argnums=1)(scene.centers, 1)
    gf_local = np.asarray(gf.addressable_data(0))
    gf_all = np.asarray(multihost_utils.process_allgather(gf_local))
    ok = (np.isfinite(gf_local).all()
          and all(np.array_equal(gf_all[o], gf_local)
                  for o in range(gf_all.shape[0])))
    if not ok:
        print(f"proc {pid}: FASTGRAD FAIL", flush=True)
        sys.exit(1)
    print(f"proc {pid}: FASTGRAD ok |g|={np.abs(gf_local).max():.3e} "
          f"psum-consistent over {nproc} processes", flush=True)


if __name__ == "__main__":
    main()
