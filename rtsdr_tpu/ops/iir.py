"""First-order IIR filtering via parallel associative scan.

The reference has no IIR capability at all; broadcast FM, however,
pre-emphasizes audio at the transmitter (+6 dB/octave above ~2.1 kHz) and a
real receiver must de-emphasize (75 us in the Americas, 50 us in Europe) or
treble is exaggerated.  A one-pole IIR

    y[n] = b * x[n] + a * y[n-1]

is a linear recurrence, which here runs as ``jax.lax.associative_scan``
over (a, b*x) pairs — O(log N) depth, fully parallel — instead of a
per-sample loop.  Block continuity carries y[-1].
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def first_order_iir(x: jax.Array, b: float, a: float,
                    y_prev: jax.Array) -> tuple[jax.Array, jax.Array]:
    """y[n] = b*x[n] + a*y[n-1] over the last axis, batched leading dims.

    y_prev: (...,) last output of the previous block; returns (y, new y_prev).
    Implemented as an associative scan over affine maps  y -> a*y + c:
    (a2, c2) o (a1, c1) = (a1*a2, a2*c1 + c2).
    """
    a_arr = jnp.full_like(x, a)
    c = b * x

    def combine(l, r):
        al, cl = l
        ar, cr = r
        return al * ar, ar * cl + cr

    a_cum, c_cum = jax.lax.associative_scan(combine, (a_arr, c), axis=-1)
    y = a_cum * y_prev[..., None] + c_cum
    return y, y[..., -1]


def deemphasis_coeffs(fs: float, tau: float = 75e-6) -> tuple[float, float]:
    """Standard FM de-emphasis one-pole coefficients (matched-z transform):
    a = exp(-1/(fs*tau)), b = 1-a (unit DC gain)."""
    a = math.exp(-1.0 / (fs * tau))
    return 1.0 - a, a


def deemphasize(x: jax.Array, y_prev: jax.Array, fs: float = 48e3,
                tau: float = 75e-6) -> tuple[jax.Array, jax.Array]:
    """Apply FM de-emphasis to an audio block (stateful)."""
    b, a = deemphasis_coeffs(fs, tau)
    return first_order_iir(x, b, a, y_prev)
