"""Receiver robustness: noisy air, long streams, sync stability.

The reference reports RDS frame sync holding for at most 4 consecutive
blocks before dropping (report §3.4, SURVEY.md §6); these tests demonstrate
indefinite hold on clean signal and graceful behavior under noise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtsdr_tpu.config import MODE0
from rtsdr_tpu.pipeline.receiver import make_receiver

from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq


def _noisy_station(n_blocks, noise_rms, seed=0x401):
    rng = np.random.default_rng(seed)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, quantize=False)
    iq = iq + noise_rms * rng.standard_normal(len(iq))
    return np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)


def _run(iq_u8, n_blocks, **kw):
    init_fn, step_fn = make_receiver(MODE0, dtype=jnp.float32,
                                     use_abs_clock=True, **kw)
    state = init_fn()
    step = jax.jit(step_fn)
    bs = MODE0.block_size
    syncs_per_block = []
    audio = []
    for b in range(n_blocks):
        state, out = step(state, jnp.asarray(iq_u8[b * bs:(b + 1) * bs]))
        syncs_per_block.append(int(np.sum(np.asarray(out.rds.is_sync))))
        audio.append(np.asarray(out.left))
    return syncs_per_block, np.concatenate(audio)


def test_long_stream_sync_holds():
    """12 blocks (~0.77 s air): after lock, every block must keep producing
    26-spaced syncs — the reference managed at most 4 consecutive blocks."""
    n_blocks = 12
    iq = _noisy_station(n_blocks, noise_rms=0.0)
    syncs, audio = _run(iq, n_blocks)
    # allow the first two blocks for carrier/clock lock
    assert all(s >= 2 for s in syncs[2:]), syncs
    assert not np.any(np.isnan(audio))


def test_noisy_station_still_decodes():
    """IQ AWGN at ~14 dB carrier SNR: audio stays clean, RDS keeps syncing
    (error-free enough for the parity check to pass most blocks)."""
    n_blocks = 8
    iq = _noisy_station(n_blocks, noise_rms=0.2)
    syncs, audio = _run(iq, n_blocks)
    assert sum(syncs[2:]) >= (n_blocks - 2), syncs  # ~>=1 sync/block avg
    assert not np.any(np.isnan(audio))
    # mono tone still dominant
    x = audio[2 * MODE0.audio_len:]
    t = np.arange(len(x)) / 48e3
    amp = np.hypot(2 * np.mean(x * np.sin(2 * np.pi * 1.1e3 * t)),
                   2 * np.mean(x * np.cos(2 * np.pi * 1.1e3 * t)))
    assert amp > 0.3  # expected ~0.44 clean (L=(mono+stereo)/2)


def test_detuned_station_decodes():
    """Realistic carrier impairment: pilot detuned +40 Hz (~2100 ppm — 40x a
    real RTL-SDR's clock error), 50 ppm receiver sample-clock error scaling
    the whole multiplex, 5 kHz tuner offset (DC after the discriminator),
    and pilot phase noise.  Stereo separation must survive (PLL tracks the
    moved 38 kHz subcarrier) and RDS must keep syncing (the squared 57 kHz
    carrier lands 240 Hz off 114 kHz).  Reference anchor: model/fmPll.py
    exists precisely to track these offsets.

    Runs with resync=True (the CLI default and the C++'s own recovery,
    src/fm_radio.cpp:699-704): on this fixture the pre-lock garbage of
    block 0 chance-matches a syndrome and poisons the 26-bit anchor, so
    the resync counter is what brings decoding back — exactly its job."""
    n_blocks = 8
    rng = np.random.default_rng(0x515)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, pilot_hz=19e3 + 40.0, ppm=50.0,
                            carrier_offset_hz=5e3, phase_noise_std=5e-4,
                            rng=rng)
    syncs, audio = _run(iq, n_blocks, resync=True)
    assert all(s >= 1 for s in syncs[5:]), f"RDS lost sync: {syncs}"
    assert sum(syncs[4:]) >= 8, f"RDS did not recover: {syncs}"
    assert not np.any(np.isnan(audio))

    # stereo separation: the 2.3 kHz L-R tone must appear in L (L-R mixes in
    # via the tracked PLL; an unlocked PLL would rotate it away)
    init_fn, step_fn = make_receiver(MODE0, dtype=jnp.float32,
                                     enable_rds=False)
    state = init_fn()
    step = jax.jit(step_fn)
    bs = MODE0.block_size
    l_all, r_all = [], []
    for b in range(n_blocks):
        state, out = step(state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
        l_all.append(np.asarray(out.left))
        r_all.append(np.asarray(out.right))
    diff = (np.concatenate(l_all) - np.concatenate(r_all))[2 * MODE0.audio_len:]
    fs = 48e3
    # the 50 ppm clock error shifts the recovered tone to 2.3 kHz * (1+ppm)
    f_tone = 2.3e3 * (1 + 50e-6)
    t = np.arange(len(diff)) / fs
    amp = np.hypot(2 * np.mean(diff * np.sin(2 * np.pi * f_tone * t)),
                   2 * np.mean(diff * np.cos(2 * np.pi * f_tone * t)))
    expected = 2 * np.pi * 75e3 * 0.45 / 240e3
    assert amp > 0.8 * expected, (
        f"stereo separation lost under detuning: {amp} vs {expected}")


def test_error_correction_raises_yield_under_clicks():
    """Burst error correction (frame.py error_correct, beyond the
    reference's detection-only syndrome check src/fm_radio.cpp:631-646)
    under impulsive interference — the error regime burst codes exist
    for.  Stationary AWGN is the WRONG fixture here: FM's wideband noise
    advantage means the RDS bit stream decodes error-free right up to
    the PLL's cliff (verified while building this test: rms 0.2..1.3
    all gave identical sync counts), so EC never fires on it.  A strong
    ~0.6 ms click (~1.5 RDS symbols before the 3 kHz LPF + RRC smear it)
    produces exactly the 1-2 bit bursts the (26,16) code corrects; one
    repaired block also saves the whole downstream sync chain from the
    re-acquisition gap."""
    n_blocks = 10
    rng = np.random.default_rng(0x404)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, quantize=False)
    click = 1500
    starts = rng.integers(MODE0.block_size, len(iq) // 2 - click, 8) * 2
    for s in starts:
        iq[s:s + 2 * click] += 2.5 * rng.standard_normal(2 * click)
    u8 = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)

    def run(ec):
        init_fn, step_fn = make_receiver(MODE0, dtype=jnp.float32,
                                         use_abs_clock=True, resync=True,
                                         error_correct=ec)
        state = init_fn()
        step = jax.jit(step_fn)
        bs = MODE0.block_size
        syncs = corrected = 0
        for b in range(n_blocks):
            state, out = step(state, jnp.asarray(u8[b * bs:(b + 1) * bs]))
            syncs += int(np.sum(np.asarray(out.rds.is_sync)))
            corrected += int(np.sum(np.asarray(out.rds.corrected)))
        return syncs, corrected

    syncs_off, corr_off = run(False)
    syncs_on, corr_on = run(True)
    assert corr_off == 0
    assert corr_on >= 1, f"EC never fired: {corr_on}"
    assert syncs_on >= syncs_off + 5, (
        f"EC did not raise yield: {syncs_on} vs {syncs_off}")


def test_heavy_noise_no_crash():
    """Garbage-dominated input: no NaNs, no exceptions, bounded audio."""
    n_blocks = 3
    iq = _noisy_station(n_blocks, noise_rms=1.5)
    syncs, audio = _run(iq, n_blocks, resync=True)
    assert not np.any(np.isnan(audio))
    assert np.all(np.abs(audio) < 1e3)


@pytest.mark.parametrize("div", [2, 4])
def test_pll_loop_div_full_chain_quality(div):
    """pll_loop_div trades golden-parity for ~div x faster PLL wall-time
    (ops/pll.py): on a detuned station the divided-loop receiver must
    still deliver stereo separation and RDS sync on par with the
    full-rate receiver — audio within tight SNR after lock."""
    n_blocks = 6
    rng = np.random.default_rng(0x517)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * MODE0.block_size // 2
    iq = synth_multiplex_iq(n, rds_wave=wave, pilot_hz=19e3 + 40.0,
                            phase_noise_std=5e-4, rng=rng)
    syncs_full, audio_full = _run(iq, n_blocks)
    syncs_div, audio_div = _run(iq, n_blocks, pll_loop_div=div)

    assert all(s >= 1 for s in syncs_div[2:]), (
        f"div={div} RDS lost sync: {syncs_div}")
    # post-lock audio agreement with the full-rate receiver: the divided
    # loop's extra phase ripple is far below audible stereo leakage
    a = audio_full[2 * MODE0.audio_len:]
    b = audio_div[2 * MODE0.audio_len:]
    err = np.sqrt(np.mean((a - b) ** 2))
    sig = np.sqrt(np.mean(a ** 2))
    snr_db = 20 * np.log10(sig / max(err, 1e-30))
    assert snr_db > 30, f"div={div}: audio SNR vs full-rate {snr_db:.1f} dB"


@pytest.mark.parametrize("cfg_name", ["MODE0", "MODE1_RDS"])
def test_gardner_survives_combined_impairments(cfg_name):
    """Combined real-world impairments — 250 ppm receiver clock skew
    (drifts the RDS sampling point ~0.9 samples/block), IQ noise, +40 Hz
    pilot detune, phase noise — through the FULL receiver: the Gardner
    timing loop (offset_mode='gardner', gain now derived from the pulse
    shape, pipeline/frame.py::gardner_gain) must keep frame sync to the
    end of the run, where the reference's held clock ('hold', its C++
    behavior src/fm_radio.cpp:529-538) has slid off the symbol peaks and
    died.  Parametrized over mode 0 and MODE1_RDS (the fractional
    ↑24/↓125 audio path + RDS, beyond the reference, which gates RDS off
    in mode 1: src/fm_radio.cpp:324) — round-3 review flagged that
    gardner was never exercised on MODE1_RDS geometry."""
    import rtsdr_tpu.config as C

    cfg = getattr(C, cfg_name)
    n_blocks = 16
    rng = np.random.default_rng(0x914)
    bits = encode_rds_blocks(rng.integers(0, 2, (40 * n_blocks, 16)))
    wave = rds_baseband(bits)
    n = n_blocks * cfg.block_size // 2
    iq = synth_multiplex_iq(n, rf_fs=cfg.rf.fs, rds_wave=wave, ppm=250.0,
                            pilot_hz=19e3 + 40.0, phase_noise_std=3e-4,
                            rng=rng, quantize=False)
    iq = iq + 0.10 * rng.standard_normal(len(iq))
    iq = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)

    def run(mode):
        init_fn, step_fn = make_receiver(cfg, dtype=jnp.float32,
                                         use_abs_clock=True, resync=True,
                                         offset_mode=mode)
        state = init_fn()
        step = jax.jit(step_fn)
        bs = cfg.block_size
        out_syncs = []
        for b in range(n_blocks):
            state, out = step(state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
            out_syncs.append(int(np.sum(np.asarray(out.rds.is_sync))))
        return out_syncs

    gard = run("gardner")
    hold = run("hold")
    # gardner: locked and still producing steady syncs at the end
    assert sum(gard[-5:]) >= 10, f"gardner lost sync: {gard}"
    # hold: the skew kills it by the end (~0.9 samples/block drift slides
    # the sampling point off the peaks) — documents why the loop exists.
    # Stray tail syncs happen (resync re-anchors on marginal matches as
    # the offset wraps toward the next peak); steady decode does not.
    assert sum(hold[-5:]) <= 3, f"hold unexpectedly survived: {hold}"


def test_gardner_gain_is_derived():
    """The loop gain is computed from the configured pulse shape (no magic
    constant): for the mode-0 RRC (beta=0.9, 24 sps) the TED slope gives
    1/slope ~= 5.87 — matching the round-3 empirical calibration of 6.0
    it replaces — and it scales with the pulse when sps/beta change."""
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.frame import gardner_gain

    g = gardner_gain(MODE0)
    assert 5.5 < g < 6.3, g


def test_stereo_blend_fades_weak_pilot():
    """stereo_blend: full separation on a nominal pilot, mono when the
    pilot is absent (stereo subcarrier still present = broken station /
    pure noise — the blend must not let the noisy L-R through)."""
    n_blocks = 3
    fs = 48e3
    f_tone = 2.3e3
    amps = {}
    for pilot_amp in (0.1, 0.0):
        iq = synth_multiplex_iq(n_blocks * MODE0.block_size // 2,
                                pilot_amp=pilot_amp, quantize=False)
        iq = np.clip(np.round(iq * 100.0 + 128.0), 0, 255).astype(np.uint8)
        init_fn, step_fn = make_receiver(MODE0, dtype=jnp.float32,
                                         enable_rds=False,
                                         stereo_blend=True)
        state = init_fn()
        step = jax.jit(step_fn)
        l_all, r_all = [], []
        bs = MODE0.block_size
        for b in range(n_blocks):
            state, out = step(state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
            l_all.append(np.asarray(out.left))
            r_all.append(np.asarray(out.right))
        diff = (np.concatenate(l_all)
                - np.concatenate(r_all))[MODE0.audio_len:]
        t = np.arange(len(diff)) / fs
        amps[pilot_amp] = np.hypot(
            2 * np.mean(diff * np.sin(2 * np.pi * f_tone * t)),
            2 * np.mean(diff * np.cos(2 * np.pi * f_tone * t)))

    expected = 2 * np.pi * 75e3 * 0.45 / 240e3
    assert amps[0.1] > 0.9 * expected, f"blend hurt a good station: {amps}"
    # no pilot: the PLL free-runs, and without blend the unsynchronized
    # mixer would still leak the 38 kHz subcarrier into L-R
    assert amps[0.0] < 0.05 * expected, f"weak-pilot stereo leaked: {amps}"


# ---- round-5 adversarial decode campaign regression tier ----
# (tools/decode_campaign.py; scenario table in DIAGNOSTICS.md)

def _campaign_yield(scenario_name, clock="hold", derotate=False,
                    n_blocks=12):
    import sys as _sys
    _sys.path.insert(0, str(__import__("pathlib").Path(
        __file__).resolve().parent.parent / "tools"))
    import decode_campaign as dc

    u8, n_groups = dc.synth_impaired(n_blocks, dc.SCENARIOS[scenario_name])
    dc._RX.clear()   # isolate from other tests' configs
    syncs, groups = dc.receiver_yield(u8, n_blocks, clock=clock,
                                      derotate=derotate)
    dc._RX.clear()
    return syncs, groups, n_groups


def test_decode_campaign_clean_and_noise_yield():
    """CLI-default receiver on the campaign synthesizer: full group yield
    (minus acquisition) on clean air and at 15 dB RF SNR."""
    for name in ("clean", "snr15"):
        syncs, groups, n_g = _campaign_yield(name)
        assert groups >= n_g - 2, (name, syncs, groups, n_g)


def test_decode_campaign_detune_needs_robust_clock():
    """The campaign's round-5 finding, pinned both ways: at +200 Hz
    pilot detune the rotated constellation blinds the reference's I-only
    one-symbol clock peek (hold: ~0 groups), while the square-law
    envelope clock + BPSK-squaring derotator decode most groups."""
    _, groups_hold, n_g = _campaign_yield("detune+200")
    assert groups_hold <= 1, groups_hold          # the documented failure
    _, groups_rob, _ = _campaign_yield("detune+200", clock="gardner",
                                       derotate=True)
    assert groups_rob >= 3, groups_rob


def test_decode_campaign_combined_harsh_robust_regains_sync():
    """detune x phase noise x ppm x AM ripple x 12 dB SNR: undecodable at
    reference parity AND for the golden model (both 0 groups, campaign
    table).  This scenario sits on the decode cliff: whether whole
    groups assemble depends on the noise realization and on platform fp
    detail (0-4 groups over seeds in float32).  The STABLE property, asserted here, is
    sync recovery: the robust clock+derotator re-acquires block sync
    where the reference-parity config stays dark (~1 lucky syndrome).
    Group-level yield at the cliff is tracked by the campaign table
    (DIAGNOSTICS.md), not pinned by a pass/fail test."""
    syncs_hold, _, _ = _campaign_yield("combined_harsh")
    syncs_rob, groups, _ = _campaign_yield("combined_harsh",
                                           clock="gardner", derotate=True)
    assert syncs_hold <= 2, syncs_hold        # the documented failure
    assert syncs_rob >= syncs_hold + 4, (syncs_hold, syncs_rob)
    # on the CPU test platform this realization also assembles groups
    # (13 syncs / 2 groups); keep a weak floor so a regression that
    # kills decode outright (not just shifts the cliff) still fails
    assert groups >= 1, (syncs_rob, groups)
