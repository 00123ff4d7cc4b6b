"""Operating-envelope sweep for the PLL loop-rate division fast mode.

`pll(loop_div=N)` runs the loop-filter recurrence every N-th sample with
bandwidth-preserving gains (ops/pll.py) — the lever on the
sequential PLL pair's chain length (PERF.md).  Promoting it beyond opt-in needs an
envelope, not one fixture: this sweeps carrier detune x in-band SNR for
BOTH production PLL instances, each seen through its production
band-pass (the real operating point), at div in {1, 2, 4}:

  stereo pilot: 19 kHz tone +/- 300 Hz, BPF 18.5-19.5 kHz, nco x2, B=0.01
  RDS carrier: 114 kHz tone +/- 1.5 kHz, BPF 113.5-114.5 kHz, nco x0.5,
      B=0.001 (the squared-carrier loop, reference src/fm_radio.cpp:338)

Per (instance, detune, SNR, div): lock amplitude |<nco . e^{-jw t}>| on
the last block (1 = perfect lock), RMS phase jitter after settling, and
the first block where lock amplitude crosses 0.9.  All detunes/SNRs run
as one batched channel axis per div, so each div's sweep is one PLL
call per block — the same kernel the receiver runs.

SNR is defined IN-BAND: tone power over noise power inside the 1 kHz
BPF passband (white noise scaled accordingly before filtering).

Run on the GPU:  python tools/pll_envelope.py [> PLL_ENVELOPE.json]
Prints one JSON line per (instance, div, detune, snr) + summary lines.
"""

from __future__ import annotations

import json
import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rtsdr_tpu.config import MODE0  # noqa: E402
from rtsdr_tpu.ops import coeffs  # noqa: E402
from rtsdr_tpu.ops.fir import fir_block, fir_zi  # noqa: E402
from rtsdr_tpu.ops.pll import pll, pll_init  # noqa: E402

FS = MODE0.rf.if_fs            # 240 kS/s
N = MODE0.if_len               # 15360 per block
BLOCKS = 10
SETTLE = 0.9
DIVS = (1, 2, 4)
SNRS_DB = (np.inf, 20.0, 10.0, 5.0)

INSTANCES = {
    "stereo": dict(
        f0=MODE0.stereo.pll.freq,                  # 19 kHz
        detunes=np.array([-300, -200, -100, -50, 0, 50, 100, 200, 300],
                         np.float64),
        bpf=(MODE0.stereo.pilot_lo, MODE0.stereo.pilot_hi,
             MODE0.stereo.taps),
        nco_scale=MODE0.stereo.pll.nco_scale,
        bw=MODE0.stereo.pll.norm_bandwidth,
    ),
    "rds": dict(
        f0=MODE0.rds.pll.freq,                     # 114 kHz
        detunes=np.array([-1500, -1000, -500, -200, 0, 200, 500, 1000,
                          1500], np.float64),
        bpf=(MODE0.rds.squared_lo, MODE0.rds.squared_hi, MODE0.rds.taps),
        nco_scale=MODE0.rds.pll.nco_scale,
        bw=MODE0.rds.pll.norm_bandwidth,
    ),
}


def run_instance(name, spec, rng):
    detunes = spec["detunes"]
    grid = [(d, s) for d in detunes for s in SNRS_DB]
    c = len(grid)
    pad = (-c) % 64 if c >= 64 else (64 - c)
    cp = c + pad

    lo, hi, taps = spec["bpf"]
    h = coeffs.bandpass_taps(FS, lo, hi, taps)
    bw_hz = hi - lo

    # synthesize all blocks up front: tone + in-band-scaled white noise
    t = np.arange(BLOCKS * N, dtype=np.float64) / FS
    sig = np.zeros((cp, BLOCKS * N), np.float32)
    for k, (d, snr) in enumerate(grid):
        x = np.cos(2 * np.pi * (spec["f0"] + d) * t)
        if np.isfinite(snr):
            # tone power 0.5; in-band noise power = sigma^2 * bw/(fs/2)
            sigma = np.sqrt(0.5 / 10 ** (snr / 10) * (FS / 2) / bw_hz)
            x = x + sigma * rng.standard_normal(len(t))
        sig[k] = x.astype(np.float32)

    results = {}
    for div in DIVS:
        zi = fir_zi(taps, (cp,), jnp.float32)
        st = pll_init((cp,), jnp.float32)

        @jax.jit
        def step(zi, st, blk):
            filt, zi2 = fir_block(blk, h, zi)
            ni, nq, st2 = pll(filt, st, freq=spec["f0"], fs=FS,
                              nco_scale=spec["nco_scale"],
                              norm_bandwidth=spec["bw"], impl="auto",
                              loop_div=div)
            return zi2, st2, ni, nq

        locks = np.zeros((BLOCKS, cp))
        jitters = np.zeros((BLOCKS, cp))
        for b in range(BLOCKS):
            blk = jnp.asarray(sig[:, b * N:(b + 1) * N])
            zi, st, ni, nq = step(zi, st, blk)
            ni = np.asarray(ni, np.float64)
            nq = np.asarray(nq, np.float64)
            tb = t[b * N:(b + 1) * N]
            for k, (d, snr) in enumerate(grid):
                f_nco = (spec["f0"] + d) * spec["nco_scale"]
                rot = np.exp(-2j * np.pi * f_nco * tb)
                z = (ni[k] + 1j * nq[k]) * rot
                zm = z.mean()
                locks[b, k] = np.abs(zm)          # nco amplitude is 1
                ph = np.angle(z * np.conj(zm / (np.abs(zm) + 1e-30)))
                jitters[b, k] = np.sqrt(np.mean(ph ** 2))

        recs = []
        for k, (d, snr) in enumerate(grid):
            settled = np.where(locks[:, k] >= SETTLE)[0]
            recs.append({
                "pll": name, "div": div, "detune_hz": float(d),
                "snr_db": None if not np.isfinite(snr) else float(snr),
                "lock": round(float(locks[-1, k]), 4),
                "jitter_rad": round(float(jitters[-1, k]), 4),
                "settle_block": (int(settled[0]) if len(settled) else -1),
            })
            print(json.dumps(recs[-1]), flush=True)
        results[div] = recs
    return results


def main():
    rng = np.random.default_rng(7)
    all_res = {}
    for name, spec in INSTANCES.items():
        all_res[name] = run_instance(name, spec, rng)

    # summary: worst-case degradation of div>1 vs div=1 over the grid
    for name, per_div in all_res.items():
        base = per_div[1]
        for div in DIVS[1:]:
            dl = [r1["lock"] - rd["lock"]
                  for r1, rd in zip(base, per_div[div])]
            dj = [rd["jitter_rad"] - r1["jitter_rad"]
                  for r1, rd in zip(base, per_div[div])]
            ds = [rd["settle_block"] - r1["settle_block"]
                  for r1, rd in zip(base, per_div[div])
                  if r1["settle_block"] >= 0 and rd["settle_block"] >= 0]
            flip = [(r1["settle_block"] >= 0) != (rd["settle_block"] >= 0)
                    for r1, rd in zip(base, per_div[div])]
            print(json.dumps({
                "summary": name, "div": div,
                "max_lock_drop": round(max(dl), 4),
                "max_jitter_increase_rad": round(max(dj), 4),
                "max_settle_delay_blocks": max(ds) if ds else None,
                "lock_state_flips": int(np.sum(flip)),
            }), flush=True)


if __name__ == "__main__":
    main()
