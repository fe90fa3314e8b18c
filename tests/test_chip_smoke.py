"""chip_smoke.py's pieces on the CPU: the last-line schema, the device
check, the nvidia-smi parser, the compile-cache helper, and every phase at
a toy size with the kernel in the Pallas interpreter.  The same phases run
compiled, at full size, when `python chip_smoke.py` runs on the card."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from bevy_raytrace_tpu.utils import compile_cache
from bevy_raytrace_tpu.utils.device import (
    parse_nvidia_smi,
    power_limit_watts,
    require_gpu,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(depth=3, grid=2, interpret=True)


def test_last_line_schema():
    devices = jax.devices()[:1]
    line = cs.last_line(devices)
    assert "\n" not in line
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": 1}}
    assert json.loads(cs.last_line(jax.devices()[:4]))["device"]["count"] == 4


def test_device_check_fails_off_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.device_phase()


def test_main_fails_off_gpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("text,cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 400.00 W\n" * 4,
     [("NVIDIA H100 80GB HBM3", "400.00 W")] * 4),
    ("Some GPU, rev 2, [N/A]", [("Some GPU, rev 2", "[N/A]")]),
])
def test_parse_nvidia_smi(text, cards):
    assert parse_nvidia_smi(text) == cards


def test_parse_nvidia_smi_rejects_garbage():
    with pytest.raises(ValueError, match="nvidia-smi"):
        parse_nvidia_smi("no comma here")


@pytest.mark.parametrize("limit,watts", [("700.00 W", 700.0),
                                         ("400.00 W", 400.0),
                                         ("[N/A]", None), ("", None)])
def test_power_limit_watts(limit, watts):
    assert power_limit_watts(limit) == watts


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_honours_env(restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}
    assert compile_cache.enable_compile_cache(env) == "/somewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_compile_cache_defaults_to_checkout(restore_cache_dir):
    path = compile_cache.enable_compile_cache({})
    assert path == os.path.join(_REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_path_is_stable_across_processes():
    code = ("from bevy_raytrace_tpu.utils.compile_cache import "
            "compile_cache_dir; print(compile_cache_dir({}))")
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu")
    paths = {subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                            check=True, capture_output=True,
                            text=True).stdout.strip()
             for cwd in (_REPO, os.path.dirname(_REPO))}
    assert paths == {compile_cache.DEFAULT_DIR}


def test_forward_phase_tiny():
    out = cs.forward_phase(width=32, height=16, spp=2, parity_spp=2, **TINY)
    assert out["kernel_s"] > 0 and out["xla_s"] > 0
    assert out["config"] == "32x16x2spp depth 3"


def test_reference_phase_tiny(tmp_path):
    out = cs.reference_phase(width=48, height=24, spp=1, depth=3,
                             interpret=True, out_dir=str(tmp_path))
    assert os.path.getsize(tmp_path / "reference.png") > 100
    assert out["kernel_rps"] > 0 and out["xla_rps"] > 0


def test_gradient_phase_tiny(tmp_path):
    out = cs.gradient_phase(width=48, height=32, spp=2, steps=3,
                            out_dir=str(tmp_path), **TINY)
    assert out["paths"] == 48 * 32 * 2
    assert os.path.exists(tmp_path / "inverse.png")


def test_decisions_phase_tiny():
    fwd = {"config": "toy", "kernel_s": 1.0, "xla_s": 2.0,
           "kernel_rps": 1.0, "xla_rps": 0.5}
    grad = {"config": "toy", "fast_s": 1.0, "paths": 1}
    out = cs.decisions_phase(fwd, grad, width=24, height=16, spp=2,
                             plane_width=24, plane_height=16, plane_spp=1,
                             **TINY)
    assert set(out) == {"onehot_s", "elementwise", "matmul"}


def test_onehot_transpose_candidate_is_exact():
    """The one-hot matmul candidate the decision times computes the same
    table cotangent as the scatter-add it competes with."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    tbl = jnp.asarray(rng.standard_normal((29, 11)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 29, 2048), jnp.int32)
    w = jnp.asarray(rng.standard_normal((2048, 11)), jnp.float32)
    a = jax.grad(lambda t: jnp.sum(cs.onehot_gather_rows(t, idx) * w))(tbl)
    b = jax.grad(lambda t: jnp.sum(t[idx] * w))(tbl)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=3e-5,
                               atol=3e-5)


def test_four_phase_tiny():
    cs.four_phase(width=32, height=16, spp=2, depth=3, grad_width=32,
                  grad_height=16, grad_spp=2, grid=2,
                  devices=jax.devices()[:4], interpret=True)
