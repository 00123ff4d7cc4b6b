"""Spectrum utilities (reference src/fourier.cpp:15-33).

The reference implements an O(N^2) DFT and a magnitude helper; here both
are thin wrappers over the batched FFT (XLA's native lowering), kept for
API parity and for the PSD/observability path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dft(x: jax.Array) -> jax.Array:
    """Full complex DFT of a real or complex signal over the last axis
    (replaces the O(N^2) loop at src/fourier.cpp:15-23 with an FFT)."""
    return jnp.fft.fft(x, axis=-1)


def magnitude(spectrum: jax.Array, normalize: bool = True) -> jax.Array:
    """|X| per bin, optionally 1/N-normalized (src/fourier.cpp:26-33)."""
    mag = jnp.abs(spectrum)
    if normalize:
        mag = mag / spectrum.shape[-1]
    return mag
