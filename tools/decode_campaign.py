"""Adversarial decode campaign: transmitter-grade synthetics under
combined impairments, receiver at CLI defaults vs the golden decoder.

The reference was validated against real RTL-SDR captures
(reference model/fmRdsBasic.py:56-58); no real capture exists in
this environment, so this is the closest achievable proxy — an
impairment sweep over streams built by the numpy/scipy-only synthesizer
(tests/oracles.py, independent of the jax decode path), reporting RDS
group yield for

  * the full receiver at CLI defaults (hold clock, resync on,
    pll_div=1, error correction off), and
  * the golden decoder (scipy golden front end + golden_rds_dsp +
    GoldenFrameDecoder — the re-hosted reference model chain).

Impairments combined per scenario: receiver sample-clock ppm error x
pilot/subcarrier detune x pilot phase noise x multipath-ish AM ripple x
RF-domain AWGN (SNR dB on the unit-envelope FM carrier).

Usage (CPU is fine; the receiver jits once per run):
    python tools/decode_campaign.py [--blocks N] [--no-golden] [--json F]

The yield table lands in DIAGNOSTICS.md; a fast regression tier runs in
tests/test_robustness.py::test_decode_campaign_scenarios.  When a real
capture exists, replay it with  `rtsdr-tpu 0 --rds-groups < capture.iq`
(see DIAGNOSTICS.md "Capture replay runbook").
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


#  Scenario grid: name -> synth kwargs + channel impairments applied to
#  the complex envelope before uint8 quantization.  Values bracket what
#  a real RTL-SDR capture exhibits (XO error tens of ppm; IEC 62106
#  transmitter tolerance is ~10 Hz but we sweep far past it; flutter =
#  slow AM from multipath/vehicle motion).
SCENARIOS = {
    "clean":        {},
    "ppm+50":       {"ppm": 50.0},
    "ppm-50":       {"ppm": -50.0},
    "detune+200":   {"pilot_hz": 19e3 + 200.0},
    "phase_noise":  {"phase_noise_std": 3e-3},
    "am_ripple":    {"ripple_depth": 0.5, "ripple_hz": 11.0},
    "snr20":        {"snr_db": 20.0},
    "snr15":        {"snr_db": 15.0},
    "snr10":        {"snr_db": 10.0},
    "combined_mild": {"ppm": 20.0, "pilot_hz": 19e3 + 100.0,
                      "phase_noise_std": 1e-3, "ripple_depth": 0.3,
                      "ripple_hz": 7.0, "snr_db": 20.0},
    "combined_harsh": {"ppm": 50.0, "pilot_hz": 19e3 + 200.0,
                       "phase_noise_std": 3e-3, "ripple_depth": 0.5,
                       "ripple_hz": 11.0, "snr_db": 12.0},
}


def synth_impaired(n_blocks, scenario, seed=0x5A):
    """uint8 stream + the number of transmitted groups."""
    import numpy as np

    from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq

    block_size = 307200
    rng = np.random.default_rng(seed)
    # ~0.73 groups/block on the 2375 bit/s stream; over-provision words
    n_groups = int(n_blocks * 0.8) + 4
    words = []
    for g in range(n_groups):   # 0A PS cycle: every group checkable
        seg = g % 4
        b = (0 << 12) | (0 << 11) | (1 << 10) | (5 << 5) | seg
        words.extend([0x3A5C, b, (226 << 8) | 106,
                      (ord("T") << 8) | ord("P")])
    wave = rds_baseband(encode_rds_blocks(words))

    kw = {k: v for k, v in scenario.items()
          if k in ("ppm", "pilot_hz", "phase_noise_std",
                   "carrier_offset_hz", "pilot_drift_hz_per_s")}
    iq = synth_multiplex_iq(n_blocks * block_size // 2, rds_wave=wave,
                            rng=rng, quantize=False, **kw)
    # groups actually on air: 2375 sym/s Manchester -> 1187.5 bit/s ->
    # 76 bits per 64 ms block; a group is 104 bits
    n_groups = min(n_groups, (n_blocks * 76) // 104)
    z = iq[0::2] + 1j * iq[1::2]

    # channel impairments on the complex envelope (scipy/numpy only)
    fs = 2.4e6
    t = np.arange(len(z)) / fs
    depth = scenario.get("ripple_depth", 0.0)
    if depth:
        z = z * (1.0 - depth * 0.5 * (1.0 + np.cos(
            2 * np.pi * scenario.get("ripple_hz", 10.0) * t)))
    snr_db = scenario.get("snr_db")
    if snr_db is not None:
        # unit-envelope FM carrier: signal power 1; complex AWGN
        sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
        z = z + sigma * (rng.standard_normal(len(z))
                         + 1j * rng.standard_normal(len(z)))
    iq2 = np.empty(2 * len(z))
    iq2[0::2] = z.real
    iq2[1::2] = z.imag
    u8 = np.clip(np.round(iq2 * 100.0 + 128.0), 0, 255).astype(np.uint8)
    return u8, n_groups


_RX = {}


def receiver_yield(u8, n_blocks, clock="hold", derotate=False):
    """Full receiver -> (synced windows, decoded groups).  Defaults are
    the CLI defaults; ``clock='gardner', derotate=True`` is the robust
    configuration the campaign recommends for impaired air."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.groups import GroupDecoder
    from rtsdr_tpu.pipeline.receiver import make_receiver

    key = (clock, derotate)
    if _RX.get("key") != key:   # one build + jit per config
        kw = {} if clock == "hold" else {"offset_mode": clock}
        init_fn, step_fn = make_receiver(MODE0, dtype=jnp.float32,
                                         resync=True, derotate=derotate,
                                         **kw)
        _RX.update(key=key, init=init_fn, step=jax.jit(step_fn))
    init_fn, step = _RX["init"], _RX["step"]
    state = init_fn()
    dec = GroupDecoder()
    bs = MODE0.block_size
    syncs = 0
    for b in range(n_blocks):
        state, out = step(state, jnp.asarray(u8[b * bs:(b + 1) * bs]))
        fo = jax.tree.map(np.asarray, out.rds)
        n_w = int(fo.n_windows)
        syncs += int(fo.is_sync[:n_w].sum())
        dec.feed(fo)
    good = sum(1 for g in dec.groups if g.pi == 0x3A5C)
    return syncs, good


def golden_yield(u8, n_blocks):
    """Golden chain (scipy front end + model bit layer) -> accepted
    syndrome count and assembled-group estimate (4 consecutive accepted
    syndromes at 26-bit spacing ~= 1 group)."""
    import numpy as np

    from oracles import GoldenFrameDecoder, golden_mono_stereo, golden_rds_dsp

    outs = golden_mono_stereo(u8, n_blocks)
    fm = outs["fm"].reshape(n_blocks, -1)
    rrc = golden_rds_dsp(list(fm))
    dec = GoldenFrameDecoder(offset_mode="hold")
    accepted = 0
    run = 0
    groups = 0
    names = []
    for (ri, rq) in rrc:
        _, events = dec.step(ri, rq)
        for name, pos, is_sync in events:
            if not is_sync:
                continue
            accepted += 1
            names.append(name)
    #  group estimate: count A,B,C/C',D runs in the accepted sequence
    want = ["A", "B", None, "D"]
    k = 0
    for nm in names:
        expect = want[k % 4]
        ok = (nm == expect) if expect else nm in ("C", "C'")
        if ok:
            k += 1
            if k % 4 == 0:
                groups += 1
        else:
            k = 1 if nm == "A" else 0
    return accepted, groups


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--no-golden", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--scenarios", type=str, default=None,
                    help="comma list (default: all)")
    ap.add_argument("--platform", type=str, default=None,
                    help="force jax platform (cpu/gpu), through "
                    "jax.config (works even when jax was imported "
                    "before JAX_PLATFORMS could apply)")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    platform = jax.devices()[0].platform

    names = (args.scenarios.split(",") if args.scenarios
             else list(SCENARIOS))
    rows = []
    for name in names:
        sc = SCENARIOS[name]
        u8, n_groups = synth_impaired(args.blocks, sc)
        syncs, groups = receiver_yield(u8, args.blocks)
        row = {"scenario": name, "platform": platform,
               "blocks": args.blocks,
               "tx_groups": n_groups, "rx_syncs": syncs,
               "rx_groups": groups,
               "rx_group_yield": round(groups / n_groups, 3)}
        if not args.no_golden:
            g_acc, g_groups = golden_yield(u8, args.blocks)
            row["golden_syncs"] = g_acc
            row["golden_groups"] = g_groups
            row["golden_group_yield"] = round(g_groups / n_groups, 3)
        rows.append(row)
        print(json.dumps(row), flush=True)
    # second pass: the robust configuration (--clock gardner --derotate)
    for name in names:
        sc = SCENARIOS[name]
        u8, n_groups = synth_impaired(args.blocks, sc)
        syncs, groups = receiver_yield(u8, args.blocks, clock="gardner",
                                       derotate=True)
        row = {"scenario": name + "/robust", "platform": platform,
               "blocks": args.blocks,
               "tx_groups": n_groups, "rx_syncs": syncs,
               "rx_groups": groups,
               "rx_group_yield": round(groups / n_groups, 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
