"""Wideband step decomposition: where do the 128 stations' ms go?

128 wideband stations (K=16 x 8 captures) and a plain 128-channel
full chain decode the same input byte volume with the same
per-station DSP; the wideband step costs more.  This tool splits the
wideband step into (a) channelizer matmul, (b) channelizer + layout +
residual mix, (c) the per-station chain fed precomputed basebands,
(d) the full wideband step, and times the plain 128-ch receiver
alongside — all interleaved-min in one process.

Run on the GPU:  python tools/profile_wideband.py [--k 16] [--b 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rtsdr_tpu.config import MODE0  # noqa: E402
from rtsdr_tpu.ops.channelizer import (  # noqa: E402
    channelizer_taps,
    channelizer_zi_u8,
    pfb_channelize_u8,
)
from rtsdr_tpu.pipeline.receiver import make_receiver  # noqa: E402
from rtsdr_tpu.pipeline.wideband import make_wideband_receiver  # noqa: E402


def slope(run, k1=3, k2=13, reps=6):
    run(k1)
    run(k2)
    t1 = min(run(k1) for _ in range(reps))
    t2 = min(run(k2) for _ in range(reps))
    return (t2 - t1) / (k2 - k1)


def interleaved(runners, k1=3, k2=13, rounds=8):
    for r in runners.values():
        r(k1)
        r(k2)
    t1 = {n: float("inf") for n in runners}
    t2 = {n: float("inf") for n in runners}
    for _ in range(rounds):
        for n, r in runners.items():
            t1[n] = min(t1[n], r(k1))
            t2[n] = min(t2[n], r(k2))
    return {n: (t2[n] - t1[n]) / (k2 - k1) for n in runners}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--b", type=int, default=8)
    args = ap.parse_args()
    cfg = MODE0
    k, b = args.k, args.b
    n_st = k * b
    rng = np.random.default_rng(0)
    wbs = k * cfg.block_size
    raw = jax.device_put(rng.integers(0, 256, (b, wbs), dtype=np.uint8))

    h = np.asarray(channelizer_taps(k, 16))
    taps = len(h)

    # (a) channelizer alone (chained: state threads)
    @jax.jit
    def chan_step(zi, r):
        y, zi2 = pfb_channelize_u8(r, h, zi, k)
        return zi2, y

    zi0 = channelizer_zi_u8(k, taps, (b,))

    def run_chan(n):
        zi = jnp.array(zi0, copy=True)
        jax.block_until_ready(zi)
        t0 = time.perf_counter()
        for _ in range(n):
            zi, y = chan_step(zi, raw)
        float(jnp.sum(y[..., :1]))
        return time.perf_counter() - t0

    # (c) per-station chain on precomputed float basebands ('iq' frontend)
    init_iq, step_iq = make_receiver(cfg, (b, k), jnp.float32,
                                     frontend_impl="iq")
    step_iq_j = jax.jit(step_iq, donate_argnums=0)
    yb = jax.device_put(
        rng.standard_normal((b, k, 2, cfg.block_size // 2)
                            ).astype(np.float32) * 0.1)

    def run_chain_iq(n):
        st = jax.tree.map(lambda x: jnp.array(x, copy=True), init_iq())
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n):
            st, out = step_iq_j(st, yb)
        float(jnp.sum(out.left[..., :1]))
        return time.perf_counter() - t0

    # (d) full wideband step
    init_wb, step_wb = make_wideband_receiver(cfg, k, (b,))
    step_wb_j = jax.jit(step_wb, donate_argnums=0)

    def run_wb(n):
        st = jax.tree.map(lambda x: jnp.array(x, copy=True), init_wb())
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n):
            st, out = step_wb_j(st, raw)
        float(jnp.sum(out.left[..., :1]))
        return time.perf_counter() - t0

    # (d') the two-stage path, same step (A/B for the composed kernel)
    init_wp, step_wp = make_wideband_receiver(cfg, k, (b,),
                                              channelizer_impl="pfb")
    step_wp_j = jax.jit(step_wp, donate_argnums=0)

    def run_wb_pfb(n):
        st = jax.tree.map(lambda x: jnp.array(x, copy=True), init_wp())
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n):
            st, out = step_wp_j(st, raw)
        float(jnp.sum(out.left[..., :1]))
        return time.perf_counter() - t0

    # (e) plain batched full chain at the same station count
    init_p, step_p = make_receiver(cfg, (n_st,), jnp.float32)
    step_p_j = jax.jit(step_p, donate_argnums=0)
    raw_p = jax.device_put(rng.integers(0, 256, (n_st, cfg.block_size),
                                        dtype=np.uint8))

    def run_plain(n):
        st = jax.tree.map(lambda x: jnp.array(x, copy=True), init_p())
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n):
            st, out = step_p_j(st, raw_p)
        float(jnp.sum(out.left[..., :1]))
        return time.perf_counter() - t0

    res = interleaved({"channelizer": run_chan, "chain_iq": run_chain_iq,
                       "wideband_full": run_wb, "wideband_pfb": run_wb_pfb,
                       "plain_full": run_plain})
    for n, dt in res.items():
        print(json.dumps({"stage": n, "stations": n_st,
                          "ms_per_step": round(dt * 1e3, 3)}), flush=True)


if __name__ == "__main__":
    main()
