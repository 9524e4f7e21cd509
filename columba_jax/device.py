"""The accelerator a measurement runs on: a GPU check and its description.

Measurements (bench.py, chip_smoke.py) run on an NVIDIA GPU and refuse to
fall back to the CPU: a CPU number under a device metric's name is wrong.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> None:
    """Exit non-zero unless JAX's default backend and first device are a
    GPU."""
    import jax

    backend = jax.default_backend()
    platform = jax.devices()[0].platform
    if backend != "gpu" or platform != "gpu":
        raise SystemExit(f"no GPU: JAX backend {backend!r}, first device "
                         f"platform {platform!r}")


def describe() -> str:
    """Each card's name and power limit as nvidia-smi reports them (one
    card per line), or why they could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    if r.returncode != 0:
        return f"nvidia-smi failed ({r.returncode}): {r.stderr.strip()}"
    return r.stdout.strip()
