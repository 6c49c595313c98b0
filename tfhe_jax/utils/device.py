"""Which accelerator a measurement ran on.

Measurement entry points (chip_smoke.py, bench.py) run only on an NVIDIA
GPU: on anything else they stop with a message instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them; exits
    with a message when there is no NVIDIA GPU to ask."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"no NVIDIA GPU found (nvidia-smi: {e})")
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Refuse anything but a GPU: no measurement falls back to the CPU."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU, but JAX found only {len(devices)} "
            f"{d.platform} device(s) ({d.device_kind})")


def describe(devices) -> dict:
    """The device as JAX reports it, for every printed result."""
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}
