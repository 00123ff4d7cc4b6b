"""Numpy/scipy golden oracles for integration tests.

Independent transcriptions of the reference's Python golden models
(model/fmMonoBlock.py, model/fmRDSblock.py, model/fmPll.py,
model/fmSupportLib.py) — block-chained scipy.signal.lfilter pipelines in
float64.  These are the fidelity target per SURVEY.md §7; tests compare the
jitted pipelines against them.

Also contains an FM multiplex synthesizer (mono + pilot + DSB-SC stereo +
RDS) so end-to-end behavior is testable without the reference's recorded IQ
captures (which are git-ignored upstream and unavailable here).
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal


# ---------------------------------------------------------------- PLL oracle
def golden_pll(pll_in, freq, fs, state, nco_scale=1.0, phase_adjust=0.0,
               norm_bandwidth=0.01):
    """State: [integrator, phaseEst, fbI, fbQ, ncoLast, trigOffset, ncoLastQ]."""
    cp, ci = 2.666, 3.555
    kp = norm_bandwidth * cp
    ki = norm_bandwidth * norm_bandwidth * ci

    n = len(pll_in)
    nco = np.empty(n + 1)
    nco_q = np.empty(n + 1)
    integrator, phase_est, fb_i, fb_q, nco_last, trig_offset, nco_last_q = state
    nco[0] = nco_last
    nco_q[0] = nco_last_q

    for k in range(n):
        error_i = pll_in[k] * (+fb_i)
        error_q = pll_in[k] * (-fb_q)
        error_d = math.atan2(error_q, error_i)
        integrator += ki * error_d
        phase_est += kp * error_d + integrator
        trig_arg = 2 * math.pi * (freq / fs) * (trig_offset + k + 1) + phase_est
        fb_i = math.cos(trig_arg)
        fb_q = math.sin(trig_arg)
        nco[k + 1] = math.cos(trig_arg * nco_scale + phase_adjust)
        nco_q[k + 1] = math.sin(trig_arg * nco_scale + phase_adjust)

    state = [integrator, phase_est, fb_i, fb_q, nco[-1], trig_offset + n,
             nco_q[-1]]
    return nco, nco_q, state


def pll_init_state():
    return [0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0]


# ----------------------------------------------------------- demod oracle
def golden_fm_demod(i, q, prev_phase=0.0):
    out = np.empty(len(i))
    for k in range(len(i)):
        current = math.atan2(q[k], i[k])
        prev_phase, current = np.unwrap([prev_phase, current])
        out[k] = current - prev_phase
        prev_phase = current
    return out, prev_phase


# ------------------------------------------------- mono/stereo chain oracle
def golden_mono_stereo(iq_u8, n_blocks, block_size=307200, rf_fs=2.4e6,
                       up=1, down=5):
    """Block-chained mono+stereo pipeline following model/fmMonoBlock.py.

    iq_u8: interleaved uint8; returns dict of concatenated outputs.
    """
    rf_taps, rf_fc, rf_decim = 151, 100e3, 10
    if_fs = rf_fs / rf_decim
    a_taps = 151 * up
    rf_coeff = signal.firwin(rf_taps, rf_fc / (rf_fs / 2), window="hann")
    audio_coeff = signal.firwin(a_taps, 16e3 / (if_fs * up / 2), window="hann")
    pilot_coeff = signal.firwin(151, [18.5e3 / (if_fs / 2), 19.5e3 / (if_fs / 2)],
                                window="hann", pass_zero="bandpass")
    chan_coeff = signal.firwin(151, [22e3 / (if_fs / 2), 54e3 / (if_fs / 2)],
                               window="hann", pass_zero="bandpass")

    zi_i = np.zeros(rf_taps - 1)
    zi_q = np.zeros(rf_taps - 1)
    prev_phase = 0.0
    zi_mono = np.zeros(a_taps - 1)
    zi_pilot = np.zeros(150)
    zi_chan = np.zeros(150)
    zi_st = np.zeros(a_taps - 1)
    pll_state = pll_init_state()

    iq = (iq_u8.astype(np.float64) - 128.0) / 128.0
    outs = {k: [] for k in ("fm", "mono", "left", "right", "stereo")}

    for b in range(n_blocks):
        blk = iq[b * block_size:(b + 1) * block_size]
        i_f, zi_i = signal.lfilter(rf_coeff, 1.0, blk[0::2], zi=zi_i)
        q_f, zi_q = signal.lfilter(rf_coeff, 1.0, blk[1::2], zi=zi_q)
        i_ds, q_ds = i_f[::rf_decim], q_f[::rf_decim]
        fm, prev_phase = golden_fm_demod(i_ds, q_ds, prev_phase)

        # mono: upsample(up) -> LPF -> [::down] * up
        um = np.zeros(len(fm) * up)
        um[::up] = fm
        mono_f, zi_mono = signal.lfilter(audio_coeff, 1.0, um, zi=zi_mono)
        mono = mono_f[::down] * up

        pilot, zi_pilot = signal.lfilter(pilot_coeff, 1.0, fm, zi=zi_pilot)
        nco, _, pll_state = golden_pll(pilot, 19e3, if_fs, pll_state, 2.0)
        chan, zi_chan = signal.lfilter(chan_coeff, 1.0, fm, zi=zi_chan)
        mixed = 2.0 * chan * nco[: len(chan)]
        us = np.zeros(len(mixed) * up)
        us[::up] = mixed
        st_f, zi_st = signal.lfilter(audio_coeff, 1.0, us, zi=zi_st)
        stereo = st_f[::down] * up

        outs["fm"].append(fm)
        outs["mono"].append(mono)
        outs["stereo"].append(stereo)
        outs["left"].append((mono + stereo) / 2)
        outs["right"].append((mono - stereo) / 2)

    return {k: np.concatenate(v) for k, v in outs.items()}


# -------------------------------------------------------- RDS chain oracle
def golden_rds_dsp(fm_blocks, if_fs=240e3):
    """RDS DSP chain (model/fmRDSblock.py:154-204) over a list of fm_demod
    blocks; returns per-block (rrc_i, rrc_q)."""
    taps = 151
    extract_coeff = signal.firwin(taps, [54e3 / (if_fs / 2), 60e3 / (if_fs / 2)],
                                  window="hann", pass_zero="bandpass")
    square_coeff = signal.firwin(taps, [113.5e3 / (if_fs / 2), 114.5e3 / (if_fs / 2)],
                                 window="hann", pass_zero="bandpass")
    lpf_coeff = signal.firwin(taps, 3e3 / (if_fs / 2), window="hann")
    anti_coeff = signal.firwin(taps, (57e3 / 2) / (if_fs * 19 / 2), window="hann")
    from rtsdr_tpu.ops.coeffs import rrc_taps as _rrc
    rrc_coeff = _rrc(57e3, 151)

    zi_e = np.zeros(taps - 1)
    zi_s = np.zeros(taps - 1)
    zi_l = np.zeros(taps - 1)
    zi_lq = np.zeros(taps - 1)
    zi_a = np.zeros(taps - 1)
    zi_aq = np.zeros(taps - 1)
    zi_r = np.zeros(150)
    zi_rq = np.zeros(150)
    pll_state = pll_init_state()
    phase_adj = math.pi / 3.3 - math.pi / 1.5

    out = []
    for fm in fm_blocks:
        extract, zi_e = signal.lfilter(extract_coeff, 1.0, fm, zi=zi_e)
        pre_pll, zi_s = signal.lfilter(square_coeff, 1.0, np.square(extract), zi=zi_s)
        nco, nco_q, pll_state = golden_pll(pre_pll, 114e3, if_fs, pll_state,
                                           0.5, phase_adj, 0.001)
        mixed = extract * nco[: len(extract)] * 2
        mixed_q = extract * nco_q[: len(extract)] * 2
        lpf, zi_l = signal.lfilter(lpf_coeff, 1.0, mixed, zi=zi_l)
        lpf_q, zi_lq = signal.lfilter(lpf_coeff, 1.0, mixed_q, zi=zi_lq)
        n = len(lpf)
        u = np.zeros(n * 19)
        uq = np.zeros(n * 19)
        u[::19] = lpf
        uq[::19] = lpf_q
        ai, zi_a = signal.lfilter(anti_coeff, 1.0, u, zi=zi_a)
        aiq, zi_aq = signal.lfilter(anti_coeff, 1.0, uq, zi=zi_aq)
        res = ai[::80] * 19
        res_q = aiq[::80] * 19
        rrc_i, zi_r = signal.lfilter(rrc_coeff, 1.0, res, zi=zi_r)
        rrc_q, zi_rq = signal.lfilter(rrc_coeff, 1.0, res_q, zi=zi_rq)
        out.append((rrc_i, rrc_q))
    return out


# ----------------------------------------------------- bit layer oracle
H = None  # filled below


def _build_h():
    from rtsdr_tpu.pipeline.frame import H_MATRIX
    return np.asarray(H_MATRIX)


SYNDROME_LIST = {
    "A": [1, 1, 1, 1, 0, 1, 1, 0, 0, 0],
    "B": [1, 1, 1, 1, 0, 1, 0, 1, 0, 0],
    "C": [1, 0, 0, 1, 0, 1, 1, 1, 0, 0],
    "D": [1, 0, 0, 1, 0, 1, 1, 0, 0, 0],
    "C'": [1, 1, 1, 1, 0, 0, 1, 1, 0, 0],  # version-B block 3 (IEC 62106)
}


class GoldenFrameDecoder:
    """Bit layer transcription of model/fmRDSblock.py:206-347, block-chained.

    offset_mode='track' follows the model's per-block clock-offset update;
    'hold' keeps the initial offset (the C++ behavior,
    src/fm_radio.cpp:529-538).
    """

    def __init__(self, offset_mode="track", with_cprime=True):
        self.h = _build_h()
        self.syndromes = dict(SYNDROME_LIST)
        if not with_cprime:   # strict 4-syndrome reference behavior
            del self.syndromes["C'"]
        self.offset_mode = offset_mode
        self.block_count = 0
        self.int_offset = 0
        self.start_pos = 0
        self.lonely_bit = 0.0
        self.front_bit = 0
        self.prebit = 0
        self.prev_sync_bits = np.zeros(0, dtype=int)
        self.printposition = 0
        self.last_position = -1

    def step(self, rrc_i, rrc_q):
        events = []
        if self.block_count == 0:
            self.int_offset = int(np.argmax(rrc_i[0:24]))

        symbols = rrc_i[self.int_offset::24]
        n_sym = len(symbols)
        if self.offset_mode == "track":
            self.int_offset = 24 - (
                np.where(rrc_i[len(rrc_i) - 24:] == symbols[-1])[0][0])

        if self.block_count == 0:
            count0 = count1 = 0
            for m in range(n_sym // 4):
                if (symbols[2 * m] > 0 and symbols[2 * m + 1] > 0) or (
                        symbols[2 * m] < 0 and symbols[2 * m + 1] < 0):
                    count0 += 1
                elif (symbols[2 * m + 1] > 0 and symbols[2 * m + 2] > 0) or (
                        symbols[2 * m + 1] < 0 and symbols[2 * m + 2] < 0):
                    count1 += 1
            self.start_pos = 1 if count0 > count1 else 0

        sp = self.start_pos
        bits = np.zeros(n_sym // 2 - sp, dtype=int)
        if sp == 1 and self.block_count != 0:
            if self.lonely_bit > symbols[0]:
                self.front_bit = 1
            elif self.lonely_bit < symbols[0]:
                self.front_bit = 0
        for k in range(len(bits)):
            if sp + 2 * k + 1 > n_sym - 1:
                break
            if symbols[2 * k + sp] > symbols[2 * k + 1 + sp]:
                bits[k] = 1
            elif symbols[2 * k + sp] < symbols[2 * k + 1 + sp]:
                bits[k] = 0
        if sp == 1:
            bits = np.insert(bits, 0, self.front_bit)
            self.lonely_bit = symbols[-1]

        if self.block_count == 0:
            self.prebit = bits[0]
            offset = 1
        else:
            offset = 0
        diff = np.zeros(len(bits) - offset, dtype=int)
        for t in range(len(diff)):
            diff[t] = self.prebit ^ bits[t + offset]
            self.prebit = bits[t + offset]
        self.prebit = bits[-1]

        if self.block_count != 0:
            diff = np.concatenate([self.prev_sync_bits, diff])

        position = 0
        while True:
            block = diff[position:position + 26]
            synd = (block @ self.h) % 2
            for name, pat in self.syndromes.items():
                if list(synd) == pat:
                    if self.last_position == -1 or (
                            self.printposition - self.last_position == 26):
                        events.append((name, self.printposition, True))
                        self.last_position = self.printposition
                    else:
                        events.append((name, self.printposition, False))
            position += 1
            if position + 26 > len(diff) - 1:
                break
            self.printposition += 1
        self.prev_sync_bits = diff[position - 1:].copy()
        self.block_count += 1
        return symbols, events


# ------------------------------------------------------------ synthesizers
# standard RDS CRC generator g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1 and the
# standard offset words (whose syndromes under the reference H are exactly
# the reference's syndrome_A..D values)
RDS_CRC_POLY = 0b10110111001
RDS_OFFSET_WORDS = {"A": 0b0011111100, "B": 0b0110011000,
                    "C": 0b0101101000, "D": 0b0110110100,
                    "C'": 0b1101010000}


def rds_crc10(info: int) -> int:
    """info(x) * x^10 mod g(x) over GF(2); info is a 16-bit MSB-first int."""
    r = info << 10
    for i in range(25, 9, -1):
        if (r >> i) & 1:
            r ^= RDS_CRC_POLY << (i - 10)
    return r & 0x3FF


def encode_rds_blocks(info_words, rng=None, cprime=True):
    """Build a standards-layout RDS bit stream: 26-bit blocks
    [info(16, MSB first) | crc^offset(10)] with offsets cycling A,B,C,D.
    This is the real over-the-air layout; under the reference H it produces
    exactly the reference's syndrome values (src/fm_radio.cpp:479-482).

    With ``cprime`` (default, the real transmitter behavior per IEC 62106),
    block 3 of a group whose block B carries version bit 1 (a version-B
    group) is sent with offset word C' instead of C.  ``cprime=False``
    reproduces the unconditional A,B,C,D cycle for strict reference-parity
    fixtures (which is what the reference's 4-syndrome H can decode).

    ``info_words``: iterable of 16-bit values — either ints or 16-element
    MSB-first bit vectors."""
    names = ["A", "B", "C", "D"]
    bits = []
    version_b = False
    for n, info in enumerate(info_words):
        if np.ndim(info) > 0:
            info = int("".join(str(int(b)) for b in np.asarray(info)), 2)
        info = int(info) & 0xFFFF
        name = names[n % 4]
        if n % 4 == 1:
            version_b = bool((info >> 11) & 1)
        elif n % 4 == 2 and version_b and cprime:
            name = "C'"
        check = rds_crc10(info) ^ RDS_OFFSET_WORDS[name]
        bits.extend((info >> (15 - k)) & 1 for k in range(16))
        bits.extend((check >> (9 - k)) & 1 for k in range(10))
    return np.array(bits, dtype=int)


def rds_baseband(bits, sps=24, span=8):
    """Differential-encode, Manchester map, RRC pulse-shape at 57 kS/s.

    Returns samples such that the receiver's matched RRC + 24-spaced
    sampling recovers the symbols.  start of data is delayed by half the
    pulse span.
    """
    from rtsdr_tpu.ops.coeffs import rrc_taps as _rrc

    # differential encode: tx[t] = tx[t-1] ^ bits[t]
    tx = np.zeros(len(bits), dtype=int)
    prev = 0
    for t, b in enumerate(bits):
        prev = prev ^ int(b)
        tx[t] = prev
    # Manchester: bit 1 -> (+,-), bit 0 -> (-,+)
    symbols = np.empty(2 * len(tx))
    symbols[0::2] = 2.0 * tx - 1.0
    symbols[1::2] = -(2.0 * tx - 1.0)
    # impulse train at symbol rate, RRC shaped
    x = np.zeros(len(symbols) * sps)
    x[::sps] = symbols
    h = _rrc(57e3, 151)
    return np.convolve(x, h, mode="full")[: len(x)]


def synth_multiplex_iq(n_samples, rf_fs=2.4e6, mono_hz=1.1e3, stereo_hz=2.3e3,
                       pilot_amp=0.1, mono_amp=0.45, stereo_amp=0.45,
                       rds_wave=None, rds_amp=0.25, deviation=75e3,
                       pilot_phase=0.0, quantize=True, rng=None,
                       pilot_hz=19e3, pilot_drift_hz_per_s=0.0,
                       phase_noise_std=0.0, carrier_offset_hz=0.0, ppm=0.0):
    """Synthesize interleaved uint8 IQ of an FM-multiplex station.

    multiplex = mono_tone + pilot(19k) + (L-R tone) x cos(2*38k pilot phase)
                + optional RDS wave DSB on 57 kHz (3rd pilot harmonic).
    ``rds_wave``: baseband at 57 kS/s (from ``rds_baseband``), resampled
    here to rf-rate grid.

    Impairment options (the regimes a real RTL-SDR capture exhibits —
    reference model/fmPll.py:22-37 is built to track exactly these):
      * ``pilot_hz``: detuned pilot; the 38 kHz stereo subcarrier and the
        57 kHz RDS carrier stay coherent at 2x/3x, as in a real exciter.
      * ``pilot_drift_hz_per_s``: linear pilot frequency drift.
      * ``phase_noise_std``: per-sample random-walk phase noise (radians)
        on the pilot (and therefore on its harmonics).
      * ``carrier_offset_hz``: RF carrier (tuner) detune -> a constant DC
        term after the FM discriminator.
      * ``ppm``: receiver sample-clock error in parts-per-million; scales
        the *entire* station (all subcarriers and the RDS symbol clock),
        which is what an XO error actually does.
    """
    clock = 1.0 + ppm * 1e-6
    t = np.arange(n_samples) / rf_fs * clock
    pilot_arg = (2 * np.pi * (pilot_hz * t
                              + 0.5 * pilot_drift_hz_per_s * t * t)
                 + pilot_phase)
    if phase_noise_std:
        assert rng is not None, "phase_noise_std requires rng"
        pilot_arg = pilot_arg + np.cumsum(
            phase_noise_std * rng.standard_normal(n_samples))
    m = (mono_amp * np.sin(2 * np.pi * mono_hz * t)
         + pilot_amp * np.cos(pilot_arg)
         + stereo_amp * np.sin(2 * np.pi * stereo_hz * t) * np.cos(2 * pilot_arg))
    if rds_wave is not None:
        # upsample 57 kS/s -> rf_fs on a common time grid (linear interp is
        # fine for a test signal; band limiting happens in the receiver)
        t57 = np.arange(len(rds_wave)) / 57e3
        rds_rf = np.interp(t, t57, rds_wave, left=0.0, right=0.0)
        m = m + rds_amp * rds_rf * np.cos(3 * pilot_arg)
    phase = 2 * np.pi * deviation * np.cumsum(m) / rf_fs
    if carrier_offset_hz:
        phase = phase + 2 * np.pi * carrier_offset_hz * np.arange(n_samples) / rf_fs
    i = np.cos(phase)
    q = np.sin(phase)
    iq = np.empty(2 * n_samples)
    iq[0::2] = i
    iq[1::2] = q
    if not quantize:
        return iq
    u8 = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)
    return u8
