"""Which implementation each op runs, chosen here and nowhere else.

* float64 runs the exact oracle paths: ``lax.conv`` FIRs and resamplers
  and the ``lax.scan`` PLL.
* float32 runs the production path that was measured fastest on the H100
  (PERF.md, "Findings"), so the CPU tests run the same float32 code as
  the card.
* The one platform rule: the PLL's Pallas kernel compiles only for the
  GPU (Triton has no CPU target), so float32 takes ``lax.scan`` on any
  other platform.

Every float32 dot and convolution asks for ``PRECISION`` (full float32):
left at the default, a float32 dot runs as TF32 on the H100 and the card
would compute something other than the CPU (NUMERICS.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PRECISION = jax.lax.Precision.HIGHEST

# op -> implementation (the alternative each one beat on the card)
FLOAT32 = {
    "fir": "matmul",          # banded-Toeplitz matmul | "conv"
    "resample": "polyphase",  # x-domain polyphase matmul | "dilated"
}
FLOAT64 = {"fir": "conv", "resample": "dilated", "pll": "scan"}


def choose(op: str, dtype) -> str:
    """The implementation of ``op`` ('fir', 'resample', 'pll') for
    operands of ``dtype``."""
    if jnp.dtype(dtype) == jnp.float64:
        return FLOAT64[op]
    if op == "pll":
        return "kernel" if jax.default_backend() == "gpu" else "scan"
    return FLOAT32[op]
