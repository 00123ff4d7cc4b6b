#!/usr/bin/env python3
"""Smoke test of the FM receiver on an NVIDIA GPU.

    python chip_smoke.py           # phases 1-5 on one card
    python chip_smoke.py --four    # phase 1, then phase 6 on four cards

Phases, all in this one process (one JAX process per card):

1. card: name and power limit, JAX version, XLA_FLAGS, compile cache,
   native host runtime;
2. station: a seeded mode-0 capture with RDS through ``rtsdr_tpu.cli.main``
   with the CLI defaults; syndromes 26 apart, the stereo test tones at
   their amplitudes, RDS events equal to the float64 oracle's;
3. fleet: mode 0 full chain (stereo + RDS + frame sync) at 1024 channels,
   a few donated steps, 4 channels against the float64 oracle, steps/s;
4. mode-1 RDS at 512 channels (the x24/125 and x57/250 resamplers),
   2 channels against the float64 oracle;
5. wideband: one K=16 capture through the composed channelizer, one
   station's audio against the two-stage PFB path;
6. four cards (``--four`` only): the channel-sharded fleet on a (4, 1) mesh
   and the time-sharded station on a (1, 4) mesh, each against the
   serial one-card run.

The float64 oracle runs on this process's CPU device.  Bounds: audio
within one int16 LSB (1/16384, the emit scale) of the oracle; RDS
syndrome sequences equal.  Every phase is a function that a CPU test
calls at tiny widths; only ``main`` insists on the GPU.  The last line of
standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
off a GPU, or when any phase fails, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AUDIO_LSB = 1.0 / 16384.0     # one int16 step at the emit scale
WIDEBAND_ATOL = 2e-4          # composed vs two-stage channelizer audio
                              # (tests/test_wideband.py: the two filter
                              # structures round differently in float32)


def _paths() -> None:
    for p in (str(ROOT / "tests"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str) -> None:
    print(msg, flush=True)


def tone_amp(x, f: float, fs: float = 48e3) -> float:
    import numpy as np

    t = np.arange(len(x)) / fs
    return float(2 * np.hypot(np.mean(x * np.cos(2 * np.pi * f * t)),
                              np.mean(x * np.sin(2 * np.pi * f * t))))


def station_capture(n_blocks: int, seed: int, cfg=None):
    """Seeded uint8 capture of one FM station with a valid RDS stream."""
    import numpy as np
    from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq

    from rtsdr_tpu.config import MODE0

    cfg = cfg or MODE0
    rng = np.random.default_rng(seed)
    wave = rds_baseband(encode_rds_blocks(
        rng.integers(0, 2, (40 * n_blocks, 16))))
    return synth_multiplex_iq(n_blocks * cfg.block_size // 2,
                              rf_fs=cfg.rf.fs, rds_wave=wave, rng=rng)


def decode(cfg, raw, n_blocks: int, dtype, device=None, **kw):
    """Run ``make_receiver`` over (C, n_blocks * block_size) bytes;
    returns per-block numpy (left, right, syndrome_id) lists."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtsdr_tpu.pipeline.receiver import make_receiver

    bs = cfg.block_size
    with jax.default_device(device or jax.devices()[0]):
        init_fn, step_fn = make_receiver(cfg, raw.shape[:-1], dtype, **kw)
        step = jax.jit(step_fn, donate_argnums=0)
        state = jax.tree.map(lambda x: jnp.array(x, copy=True), init_fn())
        outs = []
        for b in range(n_blocks):
            state, out = step(state, jnp.asarray(raw[..., b * bs:(b + 1) * bs]))
            outs.append((np.asarray(out.left), np.asarray(out.right),
                         None if out.rds is None
                         else np.asarray(out.rds.syndrome_id)))
    return outs


def oracle(cfg, raw, n_blocks: int, **kw):
    """``decode`` in float64 on the CPU device: the exact conv/scan
    paths (ops/paths.py)."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        return decode(cfg, raw, n_blocks, jnp.float64,
                      device=jax.devices("cpu")[0], **kw)


def compare(ours, ref, atol: float, what: str) -> dict:
    """Audio within ``atol``, syndrome sequences equal, block by block."""
    import numpy as np

    worst = 0.0
    for b, ((l, r, s), (l0, r0, s0)) in enumerate(zip(ours, ref)):
        worst = max(worst, float(np.max(np.abs(l - l0))),
                    float(np.max(np.abs(r - r0))))
        if s0 is not None and not np.array_equal(s, s0):
            raise AssertionError(f"{what}: block {b} syndromes differ")
    if not worst <= atol:
        raise AssertionError(f"{what}: audio off by {worst:.3g} > {atol:.3g}")
    return {"max_audio_diff": worst, "bound": atol}


# ---------------------------------------------------------------- phases

def phase_card() -> dict:
    import jax

    from rtsdr_tpu.runtime import have_native
    from rtsdr_tpu.utils.compile_cache import enable_compile_cache

    info = {"jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": enable_compile_cache(),
            "native_runtime": "loaded" if have_native() else "numpy fallback",
            "devices": [d.device_kind for d in jax.devices()]}
    log(f"[card] {json.dumps(info)}")
    return info


def phase_station(workdir: Path, n_blocks: int = 6, seed: int = 42) -> dict:
    """One station through the CLI, in this process."""
    import numpy as np

    from rtsdr_tpu import cli
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.io.stream import StreamRunner

    workdir.mkdir(parents=True, exist_ok=True)
    iq_path, audio_path = workdir / "station.iq", workdir / "audio.raw"
    station_capture(n_blocks, seed).tofile(iq_path)

    err = io.StringIO()
    saved = sys.stdin, sys.stdout, sys.stderr
    with open(iq_path, "rb") as fin, open(audio_path, "wb") as fout:
        sys.stdin, sys.stderr = fin, err
        sys.stdout = io.TextIOWrapper(fout)
        try:
            rc = cli.main(["0"])
        finally:
            sys.stdout.flush()
            sys.stdin, sys.stdout, sys.stderr = saved
    if rc != 0:
        raise AssertionError(f"station: cli exited {rc}")
    events = [ln for ln in err.getvalue().splitlines() if "Syndrome" in ln]
    synced = [ln for ln in events if not ln.startswith("False")]
    pos = [int(m.group(1)) for ln in synced
           if (m := re.search(r"position (\d+)", ln))]
    if len(pos) < 8 or np.any(np.diff(pos) != 26):
        raise AssertionError(f"station: syndrome spacing {np.diff(pos)}")

    pcm = np.fromfile(audio_path, np.int16).reshape(-1, 2) / 16384.0
    if len(pcm) != n_blocks * MODE0.audio_len:
        raise AssertionError(f"station: {len(pcm)} audio samples")
    left, right = pcm[MODE0.audio_len:, 0], pcm[MODE0.audio_len:, 1]
    mono = tone_amp(left + right, 1.1e3)
    stereo = tone_amp(left - right, 2.3e3)
    if abs(mono - 0.88) > 0.05 or abs(stereo - 0.83) > 0.05:
        raise AssertionError(f"station: tones {mono:.3f} / {stereo:.3f}")

    import jax
    import jax.numpy as jnp

    ref_events: list[str] = []
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        runner = StreamRunner(MODE0, dtype=jnp.float64, resync=True)
        with open(iq_path, "rb") as fin:
            runner.run(fin.fileno(), rds_log=ref_events.append)
    ref_events = [ln for ln in ref_events if "Syndrome" in ln]
    if events != ref_events:
        raise AssertionError(
            f"station: {len(events)} events vs the oracle's "
            f"{len(ref_events)}")
    res = {"syncs": len(synced), "events": len(events),
           "mono_1k1_amp": mono, "stereo_2k3_amp": stereo,
           "events_equal_f64": True}
    log(f"[station] {json.dumps(res)}")
    return res


def fleet_raw(cfg, n_channels: int, n_blocks: int, n_distinct: int):
    """(n_channels, n_blocks * block_size) bytes: ``n_distinct`` seeded
    stations tiled over the channels (channel c carries station c mod
    n_distinct), so the first ``n_distinct`` are all distinct."""
    import numpy as np

    st = np.stack([station_capture(n_blocks, seed, cfg)
                   for seed in range(n_distinct)])
    return np.tile(st, (-(-n_channels // n_distinct), 1))[:n_channels]


def phase_fleet(n_channels: int = 1024, n_blocks: int = 3,
                n_check: int = 4, n_timed: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.receiver import make_receiver

    cfg = MODE0
    raw = fleet_raw(cfg, n_channels, n_blocks, n_check)
    bs = cfg.block_size
    init_fn, step_fn = make_receiver(cfg, (n_channels,), jnp.float32)
    step = jax.jit(step_fn, donate_argnums=0)
    state = jax.tree.map(lambda x: jnp.array(x, copy=True), init_fn())
    blocks = [jnp.asarray(raw[:, b * bs:(b + 1) * bs])
              for b in range(n_blocks)]
    t0 = time.perf_counter()
    compiled = step.lower(state, blocks[0]).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    log(f"[fleet] memory_analysis: {mem}")

    ours = []
    for blk in blocks:
        state, out = step(state, blk)
        ours.append((jax.device_get(out.left[:n_check]),
                     jax.device_get(out.right[:n_check]),
                     jax.device_get(out.rds.syndrome_id[:n_check])))
    check = compare(ours, oracle(cfg, raw[:n_check], n_blocks),
                    AUDIO_LSB, "fleet")

    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for i in range(n_timed):
        state, out = step(state, blocks[i % n_blocks])
    jax.block_until_ready((state, out))
    dt = (time.perf_counter() - t0) / n_timed
    air_s = cfg.iq_len / cfg.rf.fs
    res = {"channels": n_channels, "compile_s": compile_s,
           "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
           "step_ms": dt * 1e3, "steps_per_s": 1.0 / dt,
           "realtime_x": n_channels * air_s / dt, **check}
    log(f"[fleet] {json.dumps(res)}")
    return res


def phase_mode1_rds(n_channels: int = 512, n_blocks: int = 2,
                    n_check: int = 2) -> dict:
    import jax.numpy as jnp

    from rtsdr_tpu.config import MODE1_RDS

    cfg = MODE1_RDS
    raw = fleet_raw(cfg, n_channels, n_blocks, n_check)
    ours = decode(cfg, raw, n_blocks, jnp.float32)
    ours = [(l[:n_check], r[:n_check], s[:n_check]) for l, r, s in ours]
    res = {"channels": n_channels,
           **compare(ours, oracle(cfg, raw[:n_check], n_blocks),
                     AUDIO_LSB, "mode1_rds")}
    log(f"[mode1_rds] {json.dumps(res)}")
    return res


def wideband_capture(k: int, slot: int, seed: int = 7):
    """One K-slot capture at K x 2.4 MS/s with a station in ``slot``."""
    import numpy as np
    from oracles import synth_multiplex_iq
    from scipy import signal

    from rtsdr_tpu.config import MODE0

    u8 = synth_multiplex_iq(MODE0.block_size // 2, quantize=False,
                            rng=np.random.default_rng(seed))
    up = signal.resample_poly(u8[0::2] + 1j * u8[1::2], k, 1)
    wide = up * np.exp(2j * np.pi * slot * np.arange(len(up)) / k)
    wide /= max(1.0, np.abs(wide).max() / 0.95)
    raw = np.empty(2 * len(wide))
    raw[0::2], raw[1::2] = wide.real, wide.imag
    return np.clip(np.round(raw * 128 + 128), 0, 255).astype(np.uint8)


def phase_wideband(k: int = 16, slot: int = 3) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.wideband import make_wideband_receiver

    raw = jnp.asarray(wideband_capture(k, slot))
    left = {}
    for impl in ("composed", "pfb"):
        init_fn, step_fn = make_wideband_receiver(
            MODE0, k, enable_rds=False, channelizer_impl=impl)
        _, out = jax.jit(step_fn)(init_fn(), raw)
        left[impl] = np.asarray(out.left[slot])
    diff = float(np.max(np.abs(left["composed"] - left["pfb"])))
    amp = tone_amp(left["composed"][MODE0.audio_len // 2:], 1.1e3)
    if not diff <= WIDEBAND_ATOL or amp < 0.15:
        raise AssertionError(f"wideband: diff {diff:.3g}, tone {amp:.3f}")
    res = {"k": k, "slot": slot, "max_audio_diff_vs_pfb": diff,
           "bound": WIDEBAND_ATOL, "mono_1k1_amp": amp}
    log(f"[wideband] {json.dumps(res)}")
    return res


def phase_four(n_channels: int = 1024, n_blocks: int = 2,
               n_devices: int = 4) -> dict:
    """Channel-sharded fleet on (n, 1) and the time-sharded station on
    (1, n), each against the serial run on the first device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.parallel.channels import make_channel_sharded_receiver
    from rtsdr_tpu.parallel.mesh import make_mesh
    from rtsdr_tpu.parallel.timeshard import make_time_sharded_receiver

    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise AssertionError(f"four: {len(devs)} devices")
    cfg, bs = MODE0, MODE0.block_size
    res = {}

    raw = fleet_raw(cfg, n_channels, n_blocks, 4)
    init_fn, step_fn, _ = make_channel_sharded_receiver(
        cfg, make_mesh(n_devices, 1, devices=devs), n_channels, jnp.float32)
    state, ours = init_fn(), []
    for b in range(n_blocks):
        state, out = step_fn(state, jnp.asarray(raw[:, b * bs:(b + 1) * bs]))
        ours.append((np.asarray(out.left), np.asarray(out.right),
                     np.asarray(out.rds.syndrome_id)))
    res["channel_sharded"] = compare(
        ours, decode(cfg, raw, n_blocks, jnp.float32), AUDIO_LSB,
        "channel_sharded")

    raw = station_capture(n_blocks, 42)[None]
    init_fn, step_fn = make_time_sharded_receiver(
        cfg, make_mesh(1, n_devices, devices=devs), 1, jnp.float32)
    state, ours = init_fn(), []
    for b in range(n_blocks):
        state, out = step_fn(state, jnp.asarray(raw[:, b * bs:(b + 1) * bs]))
        ours.append((np.asarray(out.left), np.asarray(out.right),
                     np.asarray(out.rds.syndrome_id)))
    res["time_sharded"] = compare(
        ours, decode(cfg, raw, n_blocks, jnp.float32), AUDIO_LSB,
        "time_sharded")
    log(f"[four] {json.dumps(res)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    _paths()
    import jax

    from rtsdr_tpu.utils.card import card, require_gpu

    if not require_gpu("chip_smoke"):
        return 1
    dev = jax.devices()[0]
    line = card()
    log(f"[card] {line}")
    phase_card()
    workdir = ROOT / "chiprun_out" / "chip_smoke"
    if args.four:
        phase_four()
    else:
        phase_station(workdir)
        phase_fleet()
        phase_mode1_rds()
        phase_wideband()
    log(line)    # as nvidia-smi prints it, on the line before the result
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
