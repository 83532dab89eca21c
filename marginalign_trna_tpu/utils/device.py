"""The accelerator a measurement runs on, named the way results record it."""
from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the visible cards, one
    line per card (a card below its 700 W maximum runs slower under load,
    so every number recorded from it carries this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    no card fails instead of timing the CPU backend."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("no GPU: JAX found %s devices" % dev.platform)
    return dev
