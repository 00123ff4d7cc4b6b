"""RDS DSP chain: 57 kHz subcarrier to RRC-filtered baseband.

Replaces the reference rds_thread (src/fm_radio.cpp:321-441), following the
golden model (model/fmRDSblock.py:154-204):

  extract BPF 54-60 kHz -> squaring nonlinearity -> BPF 113.5-114.5 kHz ->
  PLL at 114 kHz (nco_scale=0.5 -> coherent 57 kHz, phase_adjust tuned) ->
  I/Q mixers (x2) -> LPF 3 kHz -> rational resample x19/80 to 57 kS/s ->
  RRC matched filter.

The reference's fused square+BPF+PLL kernel (C15, src/helper.cpp:108-173)
and mixer+LPF kernel (C11, src/filter.cpp:373-401) exist here as plain
composition — XLA fuses the elementwise squaring/mixing into the
convolutions' inputs.  I and Q branches share filters via a stacked leading
dim (one convolution each for LPF/resampler/RRC).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.fir import fir_block, fir_resample, fir_zi, resample_zi
from rtsdr_tpu.ops.pll import PLLState, pll, pll_init


class RDSState(NamedTuple):
    extract_zi: jax.Array   # (..., taps-1)
    squared_zi: jax.Array   # (..., taps-1)
    pll: PLLState
    resamp_zi: jax.Array    # (..., 2, comb_taps-1) upsampled domain: the
    #                         3 kHz LPF is composed into the resampler's
    #                         anti-image filter (see composed_resampler_taps)
    rrc_zi: jax.Array       # (..., 2, rrc_taps-1)


def composed_resampler_taps(cfg: ReceiverConfig):
    """The 3 kHz LPF (IF rate) cascaded into the x19 anti-image filter.

    The reference runs LPF then resample as separate passes
    (model/fmRDSblock.py:180-199).  Upsampling commutes with convolution,
    so zero-stuffing the LPF response to the dilated rate and convolving
    with the anti-image response gives ONE filter whose x-domain polyphase
    matmul does both: ~158 effective taps per output instead of 151 — the
    entire IF-rate LPF pass (the widest buffer in the RDS chain) vanishes
    for ~1.4x the resampler's (much smaller) cost.  Exact: linear filters
    compose; coefficients are combined in float64.
    """
    import numpy as np

    r = cfg.rds
    if_fs = cfg.rf.if_fs
    lpf_h = np.asarray(coeffs.lowpass_taps(if_fs, r.lpf_fc, r.taps),
                       np.float64)
    anti_h = np.asarray(
        coeffs.lowpass_taps(if_fs * r.up, r.rrc_fs / 2, r.anti_img_taps),
        np.float64)
    lpf_u = np.zeros((r.taps - 1) * r.up + 1)
    lpf_u[::r.up] = lpf_h
    return np.convolve(lpf_u, anti_h)  # (taps-1)*up + anti_img_taps long


def rds_init(cfg: ReceiverConfig, batch_shape: tuple = (),
             dtype=jnp.float32) -> RDSState:
    r = cfg.rds
    comb_taps = (r.taps - 1) * r.up + r.anti_img_taps
    return RDSState(
        extract_zi=fir_zi(r.taps, batch_shape, dtype),
        squared_zi=fir_zi(r.taps, batch_shape, dtype),
        pll=pll_init(batch_shape, dtype),
        resamp_zi=resample_zi(comb_taps, (*batch_shape, 2), dtype),
        rrc_zi=fir_zi(r.rrc_taps, (*batch_shape, 2), dtype),
    )


def make_rds(cfg: ReceiverConfig, pll_loop_div: int = 1):
    """Returns ``rds(state, fm_demod) -> ((rrc_i, rrc_q), new_state)``.

    fm_demod: (..., if_len); rrc outputs: (..., rds_len) at 57 kS/s.
    """
    r = cfg.rds
    if_fs = cfg.rf.if_fs
    extract_h = coeffs.bandpass_taps(if_fs, r.extract_lo, r.extract_hi, r.taps)
    squared_h = coeffs.bandpass_taps(if_fs, r.squared_lo, r.squared_hi, r.taps)
    # 3 kHz LPF composed into the x19 anti-image filter: one polyphase
    # matmul does both passes (see composed_resampler_taps)
    comb_h = composed_resampler_taps(cfg)
    rrc_h = coeffs.rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta, r.symbol_rate)
    pcfg = r.pll

    def rds(state: RDSState, fm: jax.Array,
            extract: jax.Array | None = None,
            nco_pre: tuple | None = None):
        # the receiver may pass `extract` precomputed (3-fused with the
        # stereo pilot/channel band-passes over the same fm input) and
        # the carrier NCO precomputed (PLL fused with the stereo pilot
        # loop); nco_pre = (nco_i, nco_q, pll_state, squared_zi)
        if extract is None:
            extract, extract_zi = fir_block(fm, extract_h, state.extract_zi)
        else:
            extract_zi = jnp.concatenate(
                [state.extract_zi, fm], axis=-1)[..., -(r.taps - 1):]
        if nco_pre is not None:
            nco_i, nco_q, pll_state, squared_zi = nco_pre
        else:
            pre_pll, squared_zi = fir_block(extract * extract, squared_h,
                                            state.squared_zi)
            nco_i, nco_q, pll_state = pll(
                pre_pll, state.pll, freq=pcfg.freq, fs=if_fs,
                nco_scale=pcfg.nco_scale, phase_adjust=pcfg.phase_adjust,
                norm_bandwidth=pcfg.norm_bandwidth, loop_div=pll_loop_div)

        # I/Q mixers (XLA fuses them into the resampler's operand), the
        # composed 3 kHz LPF + anti-image resampler, then the RRC
        mixed = 2.0 * extract[..., None, :] * jnp.stack([nco_i, nco_q],
                                                         axis=-2)
        resamp, resamp_zi = fir_resample(mixed, comb_h, state.resamp_zi,
                                         r.up, r.down)
        rrc, rrc_zi = fir_block(resamp, rrc_h, state.rrc_zi)

        new_state = RDSState(
            extract_zi=extract_zi, squared_zi=squared_zi, pll=pll_state,
            resamp_zi=resamp_zi, rrc_zi=rrc_zi)
        return (rrc[..., 0, :], rrc[..., 1, :]), new_state

    return rds
