"""Test-session setup: force the CPU backend with 8 virtual devices.

SURVEY.md §4 item 4: distributed tests without a cluster use JAX's standard
trick — `--xla_force_host_platform_device_count=8` gives a fake 8-device CPU
mesh so shard_map logic is exercised for real.  Pallas kernels run in the
interpreter here (`interpret=True`).

`chip_smoke.py` runs the card-only tests (`pytest -m gpu`) in its own
process on the GPU and sets BRT_TESTS_ON_DEVICE=1 so that this file leaves
the platform alone.
"""

import os

if os.environ.get("BRT_TESTS_ON_DEVICE") != "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
