"""Extra throughput records beyond bench.py's two headline chains:
mode-1 (2.5 MS/s, x24/125 fractional audio resampler; RDS off, as in
the reference src/fm_radio.cpp:324) and the wideband PFB receiver
(one K-wide capture -> K stations per step).  Slope-timed like bench.py;
appends a JSON object per line.  Run on the GPU:

    python tools/bench_extras.py [--out extras.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def slope_time(step, state, raw, reps=8, n_lo=3, n_hi=13):
    """Min-of-reps slope timing of a donated-state step (bench.py style)."""
    step_j = jax.jit(step, donate_argnums=0)

    def run(k, st):
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            st, out = step_j(st, raw)
        jax.tree.leaves(out)
        float(jnp.sum(jax.tree.leaves(out)[0].ravel()[:1]))
        return time.perf_counter() - t0, st

    st = jax.tree.map(lambda x: jnp.array(x, copy=True), state)
    _, st = run(3, st)
    # min over reps of t(lo) and t(hi) SEPARATELY, then subtract (the
    # bench.py scheme).  The previous per-rep difference min was subtly
    # wrong under shared-chip contention: one burst inflating t(lo)
    # while its paired t(hi) ran clean collapses that rep's difference
    # toward zero, and the min then reports a physically impossible
    # slope (round-4's 282,514x band-scan artifact; round-5 caught a
    # 0.08 ms "wideband step" the same way).
    t_lo = np.inf
    t_hi = np.inf
    for _ in range(reps):
        t1, st = run(n_lo, st)
        t2, st = run(n_hi, st)
        t_lo = min(t_lo, t1)
        t_hi = min(t_hi, t2)
    return max(t_hi - t_lo, 1e-9) / (n_hi - n_lo)


def bench_mode1(n_ch=512):
    from rtsdr_tpu.config import MODE1
    from rtsdr_tpu.pipeline.receiver import make_receiver

    init_fn, step_fn = make_receiver(MODE1, (n_ch,), jnp.float32)
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.integers(0, 256, (n_ch, MODE1.block_size),
                                   np.uint8))
    sec = slope_time(step_fn, init_fn(), raw)
    block_s = MODE1.block_size / 2 / MODE1.rf.fs
    return {"metric": "mode1_chain_realtime_multiple_per_chip",
            "channels": n_ch, "ms_per_step": round(sec * 1e3, 4),
            "value": round(n_ch * block_s / sec, 1),
            "unit": "x_realtime"}


def bench_wideband(k=16, batch=8):
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.wideband import make_wideband_receiver

    init_fn, step_fn = make_wideband_receiver(MODE0, k, (batch,),
                                              jnp.float32)
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.integers(0, 256,
                                   (batch, k * MODE0.block_size),
                                   np.uint8))
    # init under jit, as in deployment
    sec = slope_time(step_fn, jax.jit(init_fn)(), raw)
    block_s = MODE0.block_size / 2 / MODE0.rf.fs
    stations = batch * k
    # default path: the composed channelizer+RF matmul
    # (metric name kept for comparability)
    return {"metric": "wideband_pfb_realtime_multiple_per_chip",
            "channelizer": "composed",
            "rf_channels": k, "captures": batch, "stations": stations,
            "ms_per_step": round(sec * 1e3, 4),
            "value": round(stations * block_s / sec, 1),
            "unit": "x_realtime"}


def bench_mode1_rds(n_ch=512):
    from rtsdr_tpu.config import MODE1_RDS
    from rtsdr_tpu.pipeline.receiver import make_receiver

    init_fn, step_fn = make_receiver(MODE1_RDS, (n_ch,), jnp.float32)
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.integers(0, 256, (n_ch, MODE1_RDS.block_size),
                                   np.uint8))
    sec = slope_time(step_fn, jax.jit(init_fn)(), raw)
    block_s = MODE1_RDS.block_size / 2 / MODE1_RDS.rf.fs
    return {"metric": "mode1_rds_chain_realtime_multiple_per_chip",
            "channels": n_ch, "ms_per_step": round(sec * 1e3, 4),
            "value": round(n_ch * block_s / sec, 1),
            "unit": "x_realtime"}


def bench_scan(k=16, batch=8):
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.scan import make_band_scanner

    init_fn, step_fn = make_band_scanner(MODE0, k)
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.integers(0, 256, (k * MODE0.block_size,),
                                   np.uint8))

    def step(state, raw_u8):   # metrics-first so slope_time fetches them
        m, st = step_fn(state, raw_u8)
        return st, m

    sec = slope_time(step, jax.jit(init_fn)(), raw)
    block_s = MODE0.block_size / 2 / MODE0.rf.fs
    return {"metric": "band_scan_realtime_multiple_per_chip",
            "rf_channels": k, "ms_per_step": round(sec * 1e3, 4),
            "value": round(k * block_s / sec, 1),
            "unit": "x_realtime"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    recs = []
    for fn in (bench_mode1, bench_wideband, bench_mode1_rds, bench_scan):
        r = fn()
        recs.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
