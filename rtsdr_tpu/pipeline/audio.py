"""Mono + stereo audio chains.

Replaces the reference mono_stero_thread (src/fm_radio.cpp:150-318),
following the golden model (model/fmMonoBlock.py:100-173):

  mono:   LPF 16 kHz + decimate 5   (mode 0) /  resample x24/125 (mode 1)
  stereo: pilot BPF 18.5-19.5 kHz -> PLL (nco_scale=2 -> 38 kHz subcarrier)
          channel BPF 22-54 kHz -> mixer (x NCO x 2) -> LPF 16 kHz +
          decimate/resample -> L = (mono+stereo)/2, R = (mono-stereo)/2

In mode 1 the post-mix stereo path uses the same x24/125 polyphase
resampler as mono so both land at 48 kS/s (the reference C++ instead kept
decim-by-5 and mismatched rates — a quirk we fix; filters are likewise
designed at the true rates, SURVEY.md §7).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.fir import (
    fir_block_bank,
    fir_resample,
    fir_zi,
    resample_zi,
)
from rtsdr_tpu.ops.iir import deemphasize
from rtsdr_tpu.ops.pll import PLLState, pll, pll_init


class AudioState(NamedTuple):
    mono_zi: jax.Array      # (..., mono_taps*up - 1) in the resampler domain
    pilot_zi: jax.Array | None   # (..., stereo_taps-1); None if mono-only
    chan_zi: jax.Array | None    # (..., stereo_taps-1)
    stereo_zi: jax.Array | None  # (..., mono_taps*up - 1) post-mix resampler
    pll: PLLState | None
    deemph: jax.Array | None     # (..., 2) L/R de-emphasis IIR carry


def _audio_taps(cfg: ReceiverConfig) -> int:
    # Mode 1 scales tap count by the upsampling factor so the filter keeps
    # its transition width at the dilated rate (reference
    # src/fm_radio.cpp:179: audio_taps *= audio_up).
    return cfg.mono.taps * cfg.mono.up


def audio_lpf_taps(cfg: ReceiverConfig):
    """The mono/stereo 16 kHz resampler LPF (single source of truth for
    the serial and time-sharded receivers)."""
    return coeffs.lowpass_taps(cfg.rf.if_fs * cfg.mono.up, cfg.mono.fc,
                               _audio_taps(cfg))


def audio_init(cfg: ReceiverConfig, batch_shape: tuple = (),
               dtype=jnp.float32, enable_stereo: bool = True,
               deemphasis: float | None = None) -> AudioState:
    taps = _audio_taps(cfg)
    de = (jnp.zeros((*batch_shape, 2), dtype)
          if deemphasis is not None else None)
    if not enable_stereo:
        return AudioState(mono_zi=resample_zi(taps, batch_shape, dtype),
                          pilot_zi=None, chan_zi=None, stereo_zi=None,
                          pll=None, deemph=de)
    return AudioState(
        mono_zi=resample_zi(taps, batch_shape, dtype),
        pilot_zi=fir_zi(cfg.stereo.taps, batch_shape, dtype),
        chan_zi=fir_zi(cfg.stereo.taps, batch_shape, dtype),
        stereo_zi=resample_zi(taps, batch_shape, dtype),
        pll=pll_init(batch_shape, dtype),
        deemph=de,
    )


def make_audio(cfg: ReceiverConfig, enable_stereo: bool = True,
               deemphasis: float | None = None,
               pll_loop_div: int = 1,
               stereo_blend: bool | tuple = False):
    """Returns ``audio(state, fm_demod) -> ((left, right, mono), new_state)``.

    fm_demod: (..., if_len); outputs at 48 kS/s: (..., audio_len).
    With ``enable_stereo=False`` only the mono chain runs and left = right
    = mono (the reference's mono-only lab configuration).
    ``deemphasis``: optional FM de-emphasis time constant in seconds
    (75e-6 Americas / 50e-6 Europe) applied to L/R — a capability the
    reference lacks (ops/iir.py).

    ``stereo_blend``: fade stereo toward mono as the 19 kHz pilot
    weakens (what every car radio does: the L-R subcarrier carries a
    ~20 dB noise penalty, so forcing full stereo on a weak station
    trades separation for hiss).  True = default thresholds, or a
    ``(lo, hi)`` tuple of pilot-RMS levels (in FM-demod units): the L-R
    signal scales linearly from 0 below ``lo`` to 1 above ``hi``.  The
    defaults (0.02, 0.08) put full stereo at >=57% of a nominal
    10%-deviation pilot (RMS ~0.139 at mode-0 rates) and mono below
    ~14%.  Per-block, stateless; the reference always runs full stereo.
    """
    blend_range = None
    if stereo_blend:
        blend_range = (0.02, 0.08) if stereo_blend is True else stereo_blend
        if not blend_range[1] > blend_range[0]:
            raise ValueError(
                f"stereo_blend thresholds need hi > lo, got {blend_range}")
    if_fs = cfg.rf.if_fs
    up, down = cfg.mono.up, cfg.mono.down
    taps = _audio_taps(cfg)
    # Resampler LPF cutoff: min(passband, anti-image) = 16 kHz for both
    # modes, designed at the dilated rate if_fs*up (audio_lpf_taps).
    mono_h = audio_lpf_taps(cfg)
    pilot_h = coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    chan_h = coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                  cfg.stereo.chan_hi, cfg.stereo.taps)
    pcfg = cfg.stereo.pll

    def audio(state: AudioState, fm: jax.Array,
              pilot: jax.Array | None = None,
              chan: jax.Array | None = None,
              nco_pre: tuple | None = None):
        if not enable_stereo:
            # gain=up restores the resampler's Parseval loss (C++
            # applies the same x24 at emit, src/fm_radio.cpp:206,297)
            mono, mono_zi = fir_resample(fm, mono_h, state.mono_zi,
                                         up, down)
            out, de = _deemph(mono, mono, state.deemph)
            new_state = AudioState(mono_zi=mono_zi, pilot_zi=None,
                                   chan_zi=None, stereo_zi=None, pll=None,
                                   deemph=de)
            return (*out, mono), new_state

        # pilot + channel band-passes filter the SAME input, so they share
        # one overlap-save tail and one stacked banded matmul (the windows
        # buffer is read once).  The receiver may pass them precomputed
        # (3-fused with the RDS extraction BPF, pipeline/receiver.py).
        if pilot is None or chan is None:
            (pilot, chan), if_tail = fir_block_bank(fm, [pilot_h, chan_h],
                                                    state.pilot_zi)
        else:
            if_tail = jnp.concatenate(
                [state.pilot_zi, fm], axis=-1)[..., -(cfg.stereo.taps - 1):]

        # stereo pilot -> 38 kHz NCO (the receiver may pass the NCO
        # precomputed, fused with the RDS carrier loop in one call)
        if nco_pre is not None:
            nco, pll_state = nco_pre
        else:
            nco, _, pll_state = pll(
                pilot, state.pll, freq=pcfg.freq, fs=if_fs,
                nco_scale=pcfg.nco_scale, phase_adjust=pcfg.phase_adjust,
                norm_bandwidth=pcfg.norm_bandwidth,
                delay_output=cfg.stereo.nco_delay, loop_div=pll_loop_div)

        # mix the stereo channel to baseband; then mono and stereo share
        # the same 16 kHz resampler taps and run as one stacked call (the
        # reference's C11 mixer+LPF fusion, src/filter.cpp:373-401: XLA
        # fuses the mixer into the filter's operand)
        mixed = 2.0 * chan * nco
        pair = jnp.stack([fm, mixed], axis=-2)
        pair_zi = jnp.stack([state.mono_zi, state.stereo_zi], axis=-2)
        ys, zi2 = fir_resample(pair, mono_h, pair_zi, up, down)
        mono, stereo = ys[..., 0, :], ys[..., 1, :]
        mono_zi, stereo_zi = zi2[..., 0, :], zi2[..., 1, :]

        if blend_range is not None:
            lo, hi = blend_range
            p_rms = jnp.sqrt(jnp.mean(pilot * pilot, axis=-1,
                                      keepdims=True))
            blend = jnp.clip((p_rms - lo) * (1.0 / (hi - lo)), 0.0, 1.0)
            stereo = stereo * blend
        left = 0.5 * (mono + stereo)
        right = 0.5 * (mono - stereo)
        (left, right), de = _deemph(left, right, state.deemph)

        new_state = AudioState(mono_zi=mono_zi, pilot_zi=if_tail,
                               chan_zi=if_tail, stereo_zi=stereo_zi,
                               pll=pll_state, deemph=de)
        return (left, right, mono), new_state

    def _deemph(left, right, carry):
        if deemphasis is None:
            return (left, right), None
        lr = jnp.stack([left, right], axis=-2)          # (..., 2, N)
        lr, carry = deemphasize(lr, carry, fs=cfg.audio_fs, tau=deemphasis)
        return (lr[..., 0, :], lr[..., 1, :]), carry

    return audio
