"""Benchmark: receiver throughput per GPU.

Headline metric: real-time multiple of the mono audio chain (RF front-end
FIR + discriminator + mono LPF/decimation) per card, batched over FM
channels.  One processing block = 153,600 IQ pairs = 64 ms of air time at
2.4 MS/s (reference src/fm_radio.cpp:23).

Method: K dependent steps (state threads through, so they serialize on
device), one scalar fetch, and the slope between two K values — device
throughput with the host transfer excluded (a deployment streams via
async host transfer overlapped with compute).  Prints the card's name and
power limit first; exits non-zero off a GPU.

    python bench.py

Baseline: the reference's mono mode-0 chain on its report hardware takes
9.294e-3 + 9.246e-5 + 5.944e-4 s ~= 9.98 ms per 64 ms block => 6.41x
real time (BASELINE.md rows 1-3).  vs_baseline is ours/6.41.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.config import MODE0
from rtsdr_tpu.pipeline.receiver import make_receiver
from rtsdr_tpu.utils.card import card, require_gpu
from rtsdr_tpu.utils.compile_cache import enable_compile_cache

BASELINE_REALTIME = 64e-3 / (9.294e-3 + 9.246e-5 + 5.944e-4)  # 6.41x


def _make_runner(n_channels: int, cfg=MODE0, **kwargs):
    """run(k) -> wall time of k chained (state-threaded) receiver steps."""
    init_fn, step_fn = make_receiver(cfg, (n_channels,), jnp.float32, **kwargs)
    step = jax.jit(step_fn, donate_argnums=0)

    rng = np.random.default_rng(0)
    raws = [
        jax.device_put(rng.integers(0, 256, (n_channels, cfg.block_size),
                                    dtype=np.uint8))
        for _ in range(4)
    ]

    def run(k: int) -> float:
        state = jax.tree.map(lambda x: jnp.array(x, copy=True), init_fn())
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for i in range(k):
            state, out = step(state, raws[i % len(raws)])
        float(jnp.sum(state.frontend.prev_i))  # one real device fetch
        return time.perf_counter() - t0

    return run


def _make_wideband_runner(k_slots: int, n_captures: int):
    """run(k) for the wideband receiver: n_captures parallel K-slot
    captures -> k_slots*n_captures stations per step."""
    from rtsdr_tpu.pipeline.wideband import make_wideband_receiver

    cfg = MODE0
    init_fn, step_fn = make_wideband_receiver(cfg, k_slots, (n_captures,))
    step = jax.jit(step_fn, donate_argnums=0)
    rng = np.random.default_rng(0)
    raws = [
        jax.device_put(rng.integers(
            0, 256, (n_captures, k_slots * cfg.block_size), dtype=np.uint8))
        for _ in range(2)
    ]

    def run(k: int) -> float:
        state = jax.tree.map(lambda x: jnp.array(x, copy=True), init_fn())
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for i in range(k):
            state, out = step(state, raws[i % len(raws)])
        float(jnp.sum(out.left[..., :1]))
        return time.perf_counter() - t0

    return run


def _metrics(n_channels: int, dt: float) -> dict:
    cfg = MODE0
    iq_pairs = n_channels * cfg.iq_len
    air_time = cfg.iq_len / cfg.rf.fs  # 64 ms per block per channel
    return {
        "sec_per_step": dt,
        "channels": n_channels,
        "iq_msamples_per_sec": iq_pairs / dt / 1e6,
        "realtime_multiple": n_channels * air_time / dt,
    }


def _bench_chain(n_channels: int, k1: int = 4, k2: int = 24,
                 repeats: int = 8, **kwargs) -> dict:
    run = _make_runner(n_channels, **kwargs)
    run(k1)
    run(k2)  # warm both trace paths
    t1 = min(run(k1) for _ in range(repeats))
    t2 = min(run(k2) for _ in range(repeats))
    dt = max(t2 - t1, 1e-9) / (k2 - k1)
    return _metrics(n_channels, dt)


def _bench_interleaved(configs: dict, n_channels: int | None = None,
                       k1: int = 4, k2: int = 24,
                       rounds: int = 10) -> dict:
    """Bench several receiver configs with interleaved visits.

    ``configs``: name -> kwargs (all at ``n_channels``), or
    name -> (channels, kwargs) per entry.

    Interleaving spreads any drift of the card (clocks, power) over all
    configs alike; the slope pairs each config's min t(k1) and t(k2)."""
    chans = {}
    runners = {}
    for name, spec in configs.items():
        if callable(spec):        # pre-built runner as (channels, run)
            chans[name], runners[name] = spec()
            continue
        c, kw = spec if isinstance(spec, tuple) else (n_channels, spec)
        chans[name] = c
        runners[name] = _make_runner(c, **kw)
    for run in runners.values():       # compile + warm both trace paths
        run(k1)
        run(k2)
    t1 = {name: float("inf") for name in runners}
    t2 = {name: float("inf") for name in runners}
    for _ in range(rounds):
        for name, run in runners.items():
            t1[name] = min(t1[name], run(k1))
            t2[name] = min(t2[name], run(k2))
    return {name: _metrics(chans[name],
                           max(t2[name] - t1[name], 1e-9) / (k2 - k1))
            for name in runners}


def main() -> int:
    if not require_gpu("bench"):
        return 1
    line = card()
    print(f"card: {line}", flush=True)
    enable_compile_cache()

    # operating points not yet swept on the GPU (ROADMAP S1).  fast mode:
    # PLL loop-filter at 1/4 rate, bandwidth-preserving gains, full-rate
    # NCO (ops/pll.py loop_div) — lock envelope in PERF.md, not
    # bit-identical to golden.
    res = _bench_interleaved({
        "mono": (2048, dict(enable_rds=False, enable_stereo=False)),
        "full": (1024, {}),   # mono+stereo+RDS+frame
        "fast": (1024, dict(pll_loop_div=4)),
        # wideband: 8 captures x 16 slots = 128 stations through the
        # channelizer + batched full chain
        "wideband": (lambda: (128, _make_wideband_runner(16, 8))),
    })
    mono, full, fast = res["mono"], res["full"], res["fast"]
    wb = res["wideband"]

    result = {
        "metric": "mono_chain_realtime_multiple_per_chip",
        "value": round(mono["realtime_multiple"], 1),
        "unit": "x_realtime",
        "vs_baseline": round(mono["realtime_multiple"] / BASELINE_REALTIME, 1),
        "extra": {
            "mono_iq_msamples_per_sec": round(mono["iq_msamples_per_sec"], 1),
            "mono_channels": mono["channels"],
            "mono_sec_per_block_batch": mono["sec_per_step"],
            "full_chain_realtime_multiple": round(full["realtime_multiple"], 1),
            "full_chain_channels": full["channels"],
            "full_chain_sec_per_block_batch": full["sec_per_step"],
            "full_chain_fast_realtime_multiple":
                round(fast["realtime_multiple"], 1),
            "wideband_stations": wb["channels"],
            "wideband_realtime_multiple": round(wb["realtime_multiple"], 1),
            "wideband_sec_per_block_batch": wb["sec_per_step"],
            "device": str(jax.devices()[0]),
            "device_kind": jax.devices()[0].device_kind,
            "card": line,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
