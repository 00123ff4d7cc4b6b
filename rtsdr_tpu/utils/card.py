"""The GPU a measurement ran on, as ``nvidia-smi`` names it.

A card may run below its maximum power limit, and then slower under load,
so every number taken on it is kept beside this line.
"""

from __future__ import annotations

import subprocess
import sys


def card() -> str:
    """``name, power.limit`` of the first card
    (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu(prog: str) -> bool:
    """True when JAX's first device is a GPU; otherwise says so on
    stderr and returns False (the caller exits non-zero)."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"{prog}: needs a GPU, JAX found {platform}", file=sys.stderr)
        return False
    return True
