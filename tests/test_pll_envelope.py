"""Quality gate for the PLL loop-rate-division fast mode.

A scaled-down version of tools/pll_envelope.py's sweep (the full
grid): both production PLL instances see
their tone through their production band-pass at representative detunes
and in-band SNRs, and the gate asserts the envelope the fast mode is
shipped under:

  stereo pilot (B=0.01): div 2/4 lock wherever div=1 does across
      +/-200 Hz, with lock amplitude within 0.05 of div=1 (the absolute
      amplitude is phase-noise-limited — ~0.75 at 10 dB in-band SNR even
      at div=1, so only the relative drop is meaningful);
  RDS carrier (B=0.001): div=2 acquires to +/-500 Hz unconditionally
      (the full sweep shows +/-1000 under real noise, with one ragged
      clean-signal corner at -1000); div=4 holds +/-200 Hz but does NOT
      acquire the +/-1000 Hz clean corner — the reason it stays opt-in.

Physical context for the bounds (why the envelope is generous): the FM
discriminator strips any receiver LO offset into DC, so the pilot / RDS
carrier detune seen by these loops is transmitter-side tolerance only
(IEC 62106: 57 kHz +/- 6 Hz) plus sample-clock ppm — well under 10 Hz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.config import MODE0
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.fir import fir_block, fir_zi
from rtsdr_tpu.ops.pll import pll, pll_init

FS = MODE0.rf.if_fs
N = MODE0.if_len
BLOCKS = 6


def _lock_amp(name, detunes_hz, snr_db, div, seed):
    """Last-block lock amplitude per detune (batched one PLL call)."""
    rng = np.random.default_rng(seed)
    if name == "stereo":
        f0 = MODE0.stereo.pll.freq
        lo, hi, taps = (MODE0.stereo.pilot_lo, MODE0.stereo.pilot_hi,
                        MODE0.stereo.taps)
        scale, bw = MODE0.stereo.pll.nco_scale, MODE0.stereo.pll.norm_bandwidth
    else:
        f0 = MODE0.rds.pll.freq
        lo, hi, taps = (MODE0.rds.squared_lo, MODE0.rds.squared_hi,
                        MODE0.rds.taps)
        scale, bw = MODE0.rds.pll.nco_scale, MODE0.rds.pll.norm_bandwidth
    h = coeffs.bandpass_taps(FS, lo, hi, taps)
    c = len(detunes_hz)
    t = np.arange(BLOCKS * N) / FS
    sig = np.zeros((c, BLOCKS * N), np.float32)
    for k, d in enumerate(detunes_hz):
        x = np.cos(2 * np.pi * (f0 + d) * t)
        if snr_db is not None:
            sigma = np.sqrt(0.5 / 10 ** (snr_db / 10) * (FS / 2)
                            / (hi - lo))
            x = x + sigma * rng.standard_normal(len(t))
        sig[k] = x.astype(np.float32)

    zi = fir_zi(taps, (c,), jnp.float32)
    st = pll_init((c,), jnp.float32)
    step = jax.jit(lambda zi, st, blk: (lambda f, z: (z,) + pll(
        f, st, freq=f0, fs=FS, nco_scale=scale, norm_bandwidth=bw,
        impl="auto", loop_div=div))(*fir_block(blk, h, zi)))
    for b in range(BLOCKS):
        zi, ni, nq, st = step(zi, st, jnp.asarray(sig[:, b * N:(b + 1) * N]))
    ni = np.asarray(ni, np.float64)
    nq = np.asarray(nq, np.float64)
    tb = t[(BLOCKS - 1) * N:]
    amps = []
    for k, d in enumerate(detunes_hz):
        rot = np.exp(-2j * np.pi * (f0 + d) * scale * tb)
        amps.append(np.abs(((ni[k] + 1j * nq[k]) * rot).mean()))
    return np.asarray(amps)


@pytest.mark.parametrize("div", [2, 4])
@pytest.mark.parametrize("snr_db", [None, 10.0])
def test_stereo_pilot_envelope(div, snr_db):
    """Stereo pilot loop: div 2/4 within 0.05 lock amplitude of div=1
    across +/-200 Hz, clean and at 10 dB in-band SNR (same noise)."""
    detunes = np.array([-200.0, 0.0, 200.0])
    base = _lock_amp("stereo", detunes, snr_db, 1, seed=11)
    amps = _lock_amp("stereo", detunes, snr_db, div, seed=11)
    assert np.all(base > 0.7), base       # div=1 itself locked
    assert np.all(amps > base - 0.05), (amps, base)


def test_rds_carrier_envelope_div2():
    """RDS carrier loop at div=2: acquires to +/-500 Hz on a clean
    signal — the unconditional envelope PERF.md documents."""
    detunes = np.array([-500.0, 0.0, 500.0])
    amps = _lock_amp("rds", detunes, None, 2, seed=12)
    assert np.all(amps > 0.95), amps


def test_rds_carrier_envelope_div4():
    """RDS carrier loop at div=4: the documented reduced envelope
    (+/-200 Hz) holds; the -1000 Hz clean-signal corner that div=1
    acquires is expected NOT to acquire — the reason div=4 stays
    opt-in for RDS deployments."""
    detunes = np.array([-200.0, 0.0, 200.0])
    amps = _lock_amp("rds", detunes, None, 4, seed=13)
    assert np.all(amps > 0.95), amps
    wide = _lock_amp("rds", np.array([-1000.0]), None, 4, seed=13)
    assert wide[0] < 0.5, "div=4 acquired at -1000 Hz: the envelope " \
        "documented in PERF.md is stale, consider widening it"
