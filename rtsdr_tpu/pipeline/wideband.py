"""Wideband multi-station receiver: PFB channelizer + batched receivers.

Beyond the reference (one dongle pipe = one station,
src/fm_radio.cpp:31-147): one wideband capture at ``K x 2.4 MS/s`` is
split by the polyphase channelizer (ops/channelizer.py) into K complex
basebands at exactly the station rate, and ALL K stations decode in one
jitted step through the standard batched receiver (mono + stereo + RDS +
frame sync per channel).  Channel k sits at center frequency
``k * fs_w / K`` (wrapped; ops.channelizer.channel_center_freqs).

The whole thing — channelizer matmul, banded-matmul FIRs, the fused PLL
pair — is one XLA program per block.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops.channelizer import (
    channelizer_taps,
    channelizer_zi,
    channelizer_zi_u8,
    composed_channelize_u8,
    composed_rf_taps,
    composed_zi_u8,
    pfb_channelize,
    pfb_channelize_u8,
)
from rtsdr_tpu.pipeline.frontend import rf_lpf_taps
from rtsdr_tpu.pipeline.receiver import ReceiverState, make_receiver


class WidebandState(NamedTuple):
    chan_zi: jax.Array       # channelizer carried input tail (complex)
    rx: ReceiverState        # batched per-channel receiver state
    mix_phase: jax.Array | None = None  # (K,) carried residual-NCO phase


def make_wideband_receiver(
    cfg: ReceiverConfig,
    n_rf_channels: int,
    batch_shape: tuple = (),
    dtype=jnp.float32,
    taps_per_branch: int = 16,
    channel_sharding=None,
    channel_offsets_hz=None,
    channelizer_impl: str = "auto",
    **receiver_kwargs,
):
    """Build ``(init_fn, step_fn)`` for a K-channel wideband receiver.

    ``step_fn(state, raw_u8)``: raw_u8 is (..., K * cfg.block_size)
    interleaved uint8 IQ at ``fs_w = K * cfg.rf.fs``.  Outputs are the
    standard ``ReceiverOutputs`` with a trailing (..., K) channel batch
    dim prepended to each leaf's time axis.

    ``channel_sharding``: optional ``NamedSharding`` for the channelizer
    output (K, 2, M); constrains the per-station decode onto a device
    mesh — the channelizer's banded matmul splits its output columns
    across the channel axis and everything downstream stays local
    (parallel/channels.py ``make_wideband_sharded_receiver``).

    ``channel_offsets_hz``: optional length-K residual frequency offset
    per slot — OFF-GRID station support.  A real band's 100/200 kHz
    raster does not align with the ``k * fs_w / K`` channel grid (the
    reference sidesteps this by retuning the dongle per station,
    src/fm_radio.cpp:736-764); here slot k's baseband is post-mixed by
    ``exp(-2j*pi*offset_k*m/fs_ch)`` at the channel rate, with a carried
    per-slot NCO phase so blocks chain continuously.  The PFB prototype
    passes stations up to ~±(0.45*fs_ch - 100 kHz) off-center, so any
    raster frequency inside the slot decodes with full quality.  The mix
    rides the same (K, 2, M) planes the receivers read — two fused
    elementwise FMAs per sample, no extra HBM round-trip.
    """
    k = n_rf_channels
    h = np.asarray(channelizer_taps(k, taps_per_branch))
    taps = len(h)

    offs = None
    if channel_offsets_hz is not None:
        offs = np.asarray(channel_offsets_hz, np.float64)
        assert offs.shape == (k,), f"need {k} offsets, got {offs.shape}"
        if not np.any(offs):
            offs = None

    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    # The raw-byte banded-matmul channelizer (one matmul, no complex
    # intermediates) needs whole output blocks and f32; the complex
    # phase-plane path remains for ragged lengths and the f64 oracle.
    m_per_block = cfg.block_size // 2  # per-channel samples per step
    use_u8 = dtype == jnp.float32 and m_per_block % 32 == 0

    # 'composed' folds the per-station RF front-end LPF + /10 decimator
    # INTO the channelizer matmul (ops.channelizer.composed_rf_taps):
    # no channel-rate float plane is ever written, the per-station
    # receivers start at the discriminator (frontend_impl='if'), and the
    # off-grid residual NCO moves from the channel rate to the IF rate
    # (10x fewer samples).  The two-stage path remains for ragged
    # lengths, f64, and as the parity oracle.
    assert channelizer_impl in ("auto", "composed", "pfb")
    p_if = m_per_block // cfg.rf.decim
    composed_ok = (use_u8 and m_per_block % cfg.rf.decim == 0
                   and p_if % 16 == 0)
    if channelizer_impl == "auto":
        channelizer_impl = "composed" if composed_ok else "pfb"
    elif channelizer_impl == "composed":
        assert composed_ok, "geometry ineligible for the composed kernel"
    use_composed = channelizer_impl == "composed"

    init_rx, step_rx = make_receiver(
        cfg, (*batch_shape, k), dtype,
        frontend_impl="if" if use_composed else "iq",
        **receiver_kwargs)

    if use_composed:
        g_taps = composed_rf_taps(k, h, rf_lpf_taps(cfg), cfg.rf.decim,
                                  offsets_hz=offs, fs_ch=cfg.rf.fs)

    # per-sample NCO increment and its per-block phase advance are static
    # (offsets are config, not data), so the carried phase stays small
    # and float32-exact wrapping is done in float64 at trace time
    if offs is not None:
        mix_step = -2.0 * np.pi * offs / cfg.rf.fs          # rad/sample
        blk_adv = np.mod(mix_step * m_per_block, 2.0 * np.pi)
        # NCO ramp reduced mod 2pi in float64 AT BUILD TIME: step*m is
        # data-independent, and evaluating it in f32 lets the angle grow
        # to |step|*m_per_block rad — at a 1 MHz residual offset that is
        # ~4e5 rad where the f32 ulp is 0.03 rad, i.e. ~5 kHz RMS
        # instantaneous-frequency noise on the mixed carrier.  Reduced,
        # the in-step angle stays bounded by 4pi.
        # composed path: the shift is folded into the taps and the
        # residual NCO runs at the IF rate (decim x fewer samples)
        n_mix = p_if if use_composed else m_per_block
        step_mix = mix_step * (cfg.rf.decim if use_composed else 1)
        mix_ramp = np.mod(
            np.asarray(step_mix, np.float64)[:, None]
            * np.arange(n_mix, dtype=np.float64),
            2.0 * np.pi)

    def init_fn() -> WidebandState:
        if use_composed:
            chan_zi = composed_zi_u8(g_taps.shape[1], batch_shape)
        elif use_u8:
            chan_zi = channelizer_zi_u8(k, taps, batch_shape)
        else:
            chan_zi = channelizer_zi(k, taps, batch_shape, cdtype)
        mix_phase = (jnp.zeros((k,), dtype) if offs is not None else None)
        return WidebandState(chan_zi=chan_zi, rx=init_rx(),
                             mix_phase=mix_phase)

    def step_fn(state: WidebandState, raw_u8: jax.Array):
        if use_composed:
            raw_iq, chan_zi = composed_channelize_u8(
                raw_u8, g_taps, state.chan_zi, cfg.rf.decim)
        elif use_u8:
            raw_iq, chan_zi = pfb_channelize_u8(raw_u8, h, state.chan_zi, k)
        else:
            pairs = raw_u8.reshape(*raw_u8.shape[:-1], -1, 2)
            iq = (jnp.swapaxes(pairs, -1, -2).astype(dtype)
                  - 128.0) * (1.0 / 128.0)
            x = (iq[..., 0, :] + 1j * iq[..., 1, :]).astype(cdtype)
            y, chan_zi = pfb_channelize(x, h, state.chan_zi, k)
            # (..., M, K) -> (..., K, 2, M): per-channel stacked I/Q at
            # the station rate, the receiver's 'iq' frontend input
            y = jnp.moveaxis(y, -1, -2)
            raw_iq = jnp.stack([jnp.real(y), jnp.imag(y)],
                               axis=-2).astype(dtype)
        if channel_sharding is not None:
            raw_iq = jax.lax.with_sharding_constraint(raw_iq,
                                                      channel_sharding)
        mix_phase = state.mix_phase
        if offs is not None:
            # residual per-slot downconversion at the channel rate:
            # (I + jQ) * exp(j*(phase_k + step_k*m)), the ramp pre-reduced
            # mod 2pi in float64 (see mix_ramp above)
            ang = (state.mix_phase[:, None]
                   + jnp.asarray(mix_ramp, dtype))
            c, s = jnp.cos(ang), jnp.sin(ang)     # (K, M)
            i_in = raw_iq[..., 0, :]
            q_in = raw_iq[..., 1, :]
            raw_iq = jnp.stack([i_in * c - q_in * s,
                                i_in * s + q_in * c], axis=-2)
            if channel_sharding is not None:
                raw_iq = jax.lax.with_sharding_constraint(raw_iq,
                                                          channel_sharding)
            mix_phase = jnp.mod(state.mix_phase
                                + jnp.asarray(blk_adv, dtype),
                                dtype(2.0 * np.pi))
        rx_state, out = step_rx(state.rx, raw_iq)
        return WidebandState(chan_zi=chan_zi, rx=rx_state,
                             mix_phase=mix_phase), out

    return init_fn, step_fn
