"""Real 2-process jax.distributed test.

`initialize_multihost` (shard/mesh.py) was previously untested plumbing;
here two OS processes each bring up the distributed runtime with 2
virtual CPU devices, form one global (2 hosts x 2 chips) mesh, render
sharded, and assert the assembled image is bit-identical to a
single-device render.  This exercises the actual cross-process
coordinator + collectives path, not just single-process virtual devices.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tools", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render_bitexact():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"  # never the card: the parent may hold it
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=_REPO,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "OK bit-exact" in out, f"proc {pid} output:\n{out}"
        # The collective audit must hold on the REAL
        # 2-process mesh too — zero forward collectives, KB-scale
        # backward all-reduce.
        assert "AUDIT ok fwd_collectives=0" in out, (
            f"proc {pid} output:\n{out}")
        # A gradient step must actually RUN across
        # the 2 processes (finite, psum-consistent cotangents) — both
        # the XLA wavefront step and the sharded fast (kernel record +
        # XLA replay) step.
        assert "GRADRUN ok" in out, f"proc {pid} output:\n{out}"
        assert "FASTGRAD ok" in out, f"proc {pid} output:\n{out}"
