"""What a measurement runs on: the JAX device and the card behind it.

Every number a benchmark prints names its device; a measurement path that
finds no GPU fails instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu():
    """jax.devices() if they are GPUs; raises RuntimeError otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devices[0].platform} devices "
            f"({devices[0].device_kind})")
    return devices


def device_record(devices) -> dict:
    """{"platform", "kind", "count"} as JAX reports them."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """`name, power.limit` CSV lines -> [(name, power_limit)], one per
    card, as nvidia-smi prints them (e.g. ("NVIDIA H100 80GB HBM3",
    "700.00 W"))."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def power_limit_watts(limit: str) -> float | None:
    """"700.00 W" -> 700.0; None where nvidia-smi reports no number."""
    try:
        return float(limit.split()[0])
    except (ValueError, IndexError):
        return None


def gpu_info() -> tuple[str, list[tuple[str, str]]]:
    """(raw nvidia-smi output, parsed cards)."""
    out = subprocess.run(NVIDIA_SMI_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return out.strip(), parse_nvidia_smi(out)
