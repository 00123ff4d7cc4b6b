"""A/B of each op's candidate implementations on the GPU, at fleet width.

    python tools/gpu_ab.py ops     # per-op candidates (FIR, resampler,
                                   # front end, PLL kernel vs lax.scan)
    python tools/gpu_ab.py blocks  # banded-matmul row-block sweep per site
    python tools/gpu_ab.py chain   # whole mode-0 full-chain step at 1024
                                   # channels: PLL kernel vs lax.scan

Times are host-clock medians around ``block_until_ready`` after one
warm-up call.  The FIR forms here are the package's own, whose dots ask
for ``ops.paths.PRECISION``.  Results also
go to ``chiprun_out/gpu_ab_<section>.json``.  Exits non-zero off a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rtsdr_tpu.utils.card import card, require_gpu  # noqa: E402
from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

C = 1024          # fleet channels (full-chain width)
C_M1 = 512        # mode-1 fleet width


def timed(fn, *args, reps: int = 10) -> dict:
    """Compile + warm once, then ``reps`` timed calls."""
    f = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_ms": statistics.median(ts) * 1e3,
            "min_ms": min(ts) * 1e3, "max_ms": max(ts) * 1e3,
            "first_call_s": first, "reps": reps}


def max_diff(fa, fb, *args) -> float:
    a = jax.tree.leaves(jax.jit(fa)(*args))
    b = jax.tree.leaves(jax.jit(fb)(*args))
    return max(float(jnp.max(jnp.abs(x.astype(jnp.float32)
                                     - y.astype(jnp.float32))))
               for x, y in zip(a, b))


def ops_section(rng) -> dict:
    from rtsdr_tpu.config import MODE0, MODE1, MODE1_RDS
    from rtsdr_tpu.ops import coeffs
    from rtsdr_tpu.ops import fir as F
    from rtsdr_tpu.ops.pll import pll, pll_init
    from rtsdr_tpu.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu.pipeline.rds import composed_resampler_taps

    res = {}
    cfg = MODE0
    n_if = cfg.if_len
    h151 = jnp.asarray(coeffs.lowpass_taps(240e3, 16e3, 151), jnp.float32)
    bank = jnp.stack([h151, h151 * 0.5, h151 * 0.25])

    # IF 3-filter bank (pilot, stereo channel, RDS extract)
    xext = jnp.asarray(rng.standard_normal((C, n_if + 150)), jnp.float32)
    res["if_bank3"] = {
        "matmul": timed(lambda x: F._conv1d_valid_multi_matmul(x, bank),
                        xext),
        "conv": timed(lambda x: jnp.stack(
            [F._conv1d_valid_xla(x, bank[f]) for f in range(3)], axis=-2),
            xext)}
    # single 151-tap FIR (squared RDS band-pass; pre-op square)
    res["fir_square"] = {
        "matmul": timed(lambda x: F._conv1d_valid_matmul(x * x, h151), xext),
        "conv": timed(lambda x: F._conv1d_valid_xla(x * x, h151), xext)}
    # mono + mixed stereo pair through LPF decimate-by-5
    pair = jnp.asarray(rng.standard_normal((C, 2, n_if + 150)), jnp.float32)
    res["lpf_dec5_pair"] = {
        "matmul": timed(lambda x: F._conv1d_valid_matmul(x, h151, 5), pair),
        "conv": timed(lambda x: F._conv1d_valid_xla(x, h151, 5), pair)}

    # RF front end: uint8 interleaved IQ -> decimated I/Q at the IF rate
    raw = jnp.asarray(rng.integers(0, 256, (C, cfg.block_size)), jnp.uint8)
    rf_h = jnp.asarray(coeffs.lowpass_taps(cfg.rf.fs, cfg.rf.fc, 151),
                       jnp.float32)

    def split(raw, fir):
        pairs = raw.reshape(C, -1, 2)
        iq = (jnp.swapaxes(pairs, -1, -2).astype(jnp.float32)
              - 128.0) * (1.0 / 128.0)
        iq = jnp.concatenate([jnp.zeros((C, 2, 150), jnp.float32), iq], -1)
        return fir(iq, rf_h, 10)

    res["ingest"] = {
        "split_conv": timed(lambda r: split(r, F._conv1d_valid_xla), raw),
        "split_matmul": timed(lambda r: split(r, F._conv1d_valid_matmul),
                              raw)}

    # rational resamplers: x-domain polyphase matmul vs dilated conv
    def dilated(x, h, z, up, down):
        n = x.shape[-1]
        u = jnp.pad(x[..., None], [(0, 0)] * x.ndim + [(0, up - 1)])
        u = u.reshape(*x.shape[:-1], n * up)
        return F._conv1d_valid_xla(jnp.concatenate([z, u], -1), h, down)

    for name, c, n, h, up, down in (
            ("rds_x19_80", C, n_if, composed_resampler_taps(MODE0), 19, 80),
            ("m1_audio_x24_125", C_M1, MODE1.if_len, audio_lpf_taps(MODE1),
             24, 125),
            ("m1_rds_x57_250", C_M1, MODE1_RDS.if_len,
             composed_resampler_taps(MODE1_RDS), 57, 250)):
        h = jnp.asarray(h, jnp.float32)
        x = jnp.asarray(rng.standard_normal((c, 2, n)), jnp.float32)
        z = jnp.zeros((c, 2, h.shape[0] - 1), jnp.float32)
        res[name] = {
            "taps": int(h.shape[0]), "channels": c,
            "polyphase": timed(lambda x, z: F._resample_polyphase_matmul(
                x, h, z, up, down)[0], x, z),
            "dilated": timed(lambda x, z: dilated(x, h, z, up, down), x, z)}
        res[name]["maxdiff"] = max_diff(
            lambda x, z: F._resample_polyphase_matmul(x, h, z, up, down)[0],
            lambda x, z: dilated(x, h, z, up, down), x, z)

    # the fused PLL pair at 2 x 1024 lanes over one mode-0 block
    t = np.arange(n_if) / cfg.rf.if_fs
    ph = rng.uniform(0, 2 * np.pi, (2, C, 1))
    xp = jnp.asarray(np.cos(2 * np.pi * np.array([19e3, 114e3])[:, None, None]
                            * t + ph), jnp.float32)
    kw = dict(freq=np.array([19e3, 114e3]).reshape(2, 1), fs=cfg.rf.if_fs,
              nco_scale=np.array([2.0, 0.5]).reshape(2, 1),
              phase_adjust=np.array([0.0, -1.0]).reshape(2, 1),
              norm_bandwidth=np.array([0.01, 0.001]).reshape(2, 1))
    st = pll_init((2, C), jnp.float32)
    pl_res = {"lanes": 2 * C, "steps": n_if}
    pl_res["kernel"] = timed(
        lambda x, s: pll(x, s, impl="kernel", **kw), xp, st)
    for unroll in (1, 2, 8):
        pl_res[f"scan_unroll{unroll}"] = timed(
            lambda x, s, u=unroll: pll(x, s, impl="scan", unroll=u, **kw),
            xp, st, reps=3)
    pl_res["kernel_vs_scan_maxdiff"] = max_diff(
        lambda x, s: pll(x, s, impl="kernel", **kw)[:2],
        lambda x, s: pll(x, s, impl="scan", **kw)[:2], xp, st)
    res["pll_pair"] = pl_res
    return res


def blocks_section(rng) -> dict:
    """Row-block sweep of the banded matmuls at the fleet's call sites."""
    from rtsdr_tpu.config import MODE0, MODE1, MODE1_RDS
    from rtsdr_tpu.ops import coeffs
    from rtsdr_tpu.ops import fir as F
    from rtsdr_tpu.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu.pipeline.rds import composed_resampler_taps

    res = {}
    n_if = MODE0.if_len
    h151 = jnp.asarray(coeffs.lowpass_taps(240e3, 16e3, 151), jnp.float32)
    bank = jnp.stack([h151, h151 * 0.5, h151 * 0.25])
    xext = jnp.asarray(rng.standard_normal((C, n_if + 150)), jnp.float32)
    res["if_bank3"] = {b: timed(lambda x, b=b: F._conv1d_valid_multi_matmul(
        x, bank, block=b), xext) for b in (32, 64, 128, 256)}
    pair = jnp.asarray(rng.standard_normal((C, 2, n_if + 150)), jnp.float32)
    res["lpf_dec5_pair"] = {b: timed(lambda x, b=b: F._conv1d_valid_matmul(
        x, h151, 5, block=b), pair) for b in (8, 16, 32, 64, 128)}
    iq = jnp.asarray(rng.standard_normal((C, 2, MODE0.iq_len + 150)),
                     jnp.float32)
    res["rf_dec10"] = {b: timed(lambda x, b=b: F._conv1d_valid_matmul(
        x, h151, 10, block=b), iq) for b in (8, 16, 32, 64, 128)}
    for name, c, n, h, up, down in (
            ("rds_x19_80", C, n_if, composed_resampler_taps(MODE0), 19, 80),
            ("m1_audio_x24_125", C_M1, MODE1.if_len, audio_lpf_taps(MODE1),
             24, 125),
            ("m1_rds_x57_250", C_M1, MODE1_RDS.if_len,
             composed_resampler_taps(MODE1_RDS), 57, 250)):
        h = jnp.asarray(h, jnp.float32)
        x = jnp.asarray(rng.standard_normal((c, 2, n)), jnp.float32)
        z = jnp.zeros((c, 2, h.shape[0] - 1), jnp.float32)
        res[name] = {
            b: timed(lambda x, z, b=b: F._resample_polyphase_matmul(
                x, h, z, up, down, block=b)[0], x, z)
            for b in sorted({up * k for k in (1, 2, 4, 8)
                             if (n * up // down) % (up * k) == 0})}
    res["rule"] = {
        "if_bank3": F._block_for_stride(1, 151),
        "lpf_dec5_pair": F._block_for_stride(5, 151),
        "rf_dec10": F._block_for_stride(10, 151)}
    return {k: {str(b): v for b, v in d.items()} for k, d in res.items()}


def chain_section(rng) -> dict:
    """The whole mode-0 full-chain step (stereo + RDS + frame) at 1024
    channels, PLL kernel vs lax.scan, same process."""
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.ops import paths
    from rtsdr_tpu.pipeline.receiver import make_receiver

    raw = jnp.asarray(rng.integers(0, 256, (C, MODE0.block_size)), jnp.uint8)
    res = {"channels": C}
    choose = paths.choose
    for name, pll_impl in (("kernel", "kernel"), ("scan", "scan"),
                           ("kernel_again", "kernel")):
        paths.choose = (lambda op, dtype, _i=pll_impl:
                        _i if op == "pll" else choose(op, dtype))
        try:
            init_fn, step_fn = make_receiver(MODE0, (C,), jnp.float32)
            state = init_fn()
            res[name] = timed(lambda s, r: step_fn(s, r)[1], state, raw,
                              reps=5 if pll_impl == "scan" else 10)
        finally:
            paths.choose = choose
    res["air_s_per_step"] = C * MODE0.iq_len / MODE0.rf.fs
    return res


def main() -> int:
    sections = sys.argv[1:] or ["ops"]
    if not require_gpu("gpu_ab"):
        return 1
    enable_compile_cache()
    head = {"card": card(), "device_kind": jax.devices()[0].device_kind,
            "jax": jax.__version__, "xla_flags": os.environ.get("XLA_FLAGS")}
    print(json.dumps(head))
    for section in sections:
        rng = np.random.default_rng(7)
        res = {"ops": ops_section, "blocks": blocks_section,
               "chain": chain_section}[section](rng)
        res["head"] = head
        os.makedirs("chiprun_out", exist_ok=True)
        with open(f"chiprun_out/gpu_ab_{section}.json", "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({section: res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
