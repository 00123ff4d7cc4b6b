"""RF front end: uint8 ingest, IQ LPF + decimate to IF, FM discrimination.

Replaces the reference rf_thread (src/fm_radio.cpp:31-147): deinterleave,
151-tap LPF at Fc=100 kHz fused with the /10 decimator on both I and Q,
then the discriminator.  Coefficients are computed once at build time, not
per block (reference quirk at src/fm_radio.cpp:75).

Inputs, by ``impl``:
  * 'u8'  — raw interleaved uint8 IQ: normalize and deinterleave, then a
            batched I+Q decimating FIR (the reference's C7 "fused I+Q"
            kernel is here simply a batched leading dim; XLA fuses the
            normalize into the filter's operand).
  * 'iq'  — float I/Q stacked as (..., 2, n): the wideband channelizer's
            per-channel baseband (pipeline/wideband.py); skips
            normalize/deinterleave.
  * 'if'  — RF-filtered and decimated float I/Q stacked as (..., 2,
            if_len): the composed channelizer's output
            (ops.channelizer.composed_channelize_u8); only the
            discriminator runs here (the FIR state fields ride along
            untouched so the state pytree keeps one shape).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.demod import demod_init, fm_discriminator
from rtsdr_tpu.ops.fir import fir_decimate, fir_zi


class FrontendState(NamedTuple):
    zi_i: jax.Array       # (..., rf_taps-1)
    zi_q: jax.Array
    prev_i: jax.Array     # (...,) discriminator state
    prev_q: jax.Array


def frontend_init(cfg: ReceiverConfig, batch_shape: tuple = (),
                  dtype=jnp.float32) -> FrontendState:
    pi, pq = demod_init(batch_shape, dtype)
    return FrontendState(
        zi_i=fir_zi(cfg.rf.taps, batch_shape, dtype),
        zi_q=fir_zi(cfg.rf.taps, batch_shape, dtype),
        prev_i=pi,
        prev_q=pq,
    )


def rf_lpf_taps(cfg: ReceiverConfig):
    """The RF front-end LPF (single source of truth — the wideband
    composed channelizer folds in the SAME design)."""
    return coeffs.lowpass_taps(cfg.rf.fs, cfg.rf.fc, cfg.rf.taps)


def make_frontend(cfg: ReceiverConfig, dtype=jnp.float32, impl: str = "u8"):
    """Returns ``frontend(state, raw) -> (fm_demod, new_state)``.

    raw: (..., block_size) interleaved uint8 for impl='u8'; fm_demod:
    (..., if_len).
    """
    rf_h = rf_lpf_taps(cfg)
    decim = cfg.rf.decim
    if impl not in ("u8", "iq", "if"):
        raise ValueError(f"unknown frontend impl {impl!r}")

    def frontend(state: FrontendState, raw: jax.Array):
        if impl == "if":
            fm, (pi, pq) = fm_discriminator(
                raw[..., 0, :], raw[..., 1, :],
                (state.prev_i, state.prev_q))
            return fm, state._replace(prev_i=pi, prev_q=pq)
        if impl == "iq":
            iq = raw  # already float (..., 2, n)
        else:
            pairs = raw.reshape(*raw.shape[:-1], -1, 2)
            iq = (jnp.swapaxes(pairs, -1, -2).astype(dtype)
                  - 128.0) * (1.0 / 128.0)
        zi = jnp.stack([state.zi_i, state.zi_q], axis=-2)
        iq_ds, zi_new = fir_decimate(iq, rf_h, zi, decim)
        i_ds = iq_ds[..., 0, :]
        q_ds = iq_ds[..., 1, :]
        zi_i = zi_new[..., 0, :]
        zi_q = zi_new[..., 1, :]
        fm, (pi, pq) = fm_discriminator(i_ds, q_ds,
                                        (state.prev_i, state.prev_q))
        new_state = FrontendState(zi_i=zi_i, zi_q=zi_q, prev_i=pi, prev_q=pq)
        return fm, new_state

    return frontend
