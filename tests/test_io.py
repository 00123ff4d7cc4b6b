"""Native runtime (C++ ingest/emit/reader) and CLI streaming loop."""

import os
import subprocess
import sys

import numpy as np
import pytest

from rtsdr_tpu.runtime import (
    BlockReader,
    deinterleave_normalize,
    emit_int16_interleave,
    have_native,
)
from rtsdr_tpu.utils.compile_cache import DEFAULT_DIR

from oracles import synth_multiplex_iq


def test_native_library_builds():
    assert have_native(), "C++ runtime failed to build"


def test_deinterleave_normalize(rng):
    raw = rng.integers(0, 256, 1000, dtype=np.uint8)
    i, q = deinterleave_normalize(raw)
    ref = (raw.astype(np.float32) - 128.0) / 128.0
    np.testing.assert_array_equal(i, ref[0::2])
    np.testing.assert_array_equal(q, ref[1::2])


def test_emit_int16(rng):
    left = rng.standard_normal(100).astype(np.float32) * 0.5
    right = rng.standard_normal(100).astype(np.float32) * 0.5
    left[3] = np.nan
    left[4] = 10.0  # clips
    out = emit_int16_interleave(left, right, 16384.0)
    assert out.shape == (200,)
    assert out[6] == 0          # NaN guard
    assert out[8] == 32767      # clip
    np.testing.assert_array_equal(
        out[1::2], np.clip(right * 16384.0, -32768, 32767).astype(np.int16))


def test_block_reader_read_into(tmp_path):
    """read_block_into fills a caller row without allocation — the
    multi-fd staging path (io/batch.py) — and matches read_block."""
    data = np.arange(256, dtype=np.uint8).tobytes() * 100
    f = tmp_path / "stream.bin"
    f.write_bytes(data)
    fd = os.open(str(f), os.O_RDONLY)
    dst = np.empty((3, 6400), np.uint8)
    with BlockReader(fd, 6400) as reader:
        assert reader.read_block_into(dst[0])
        assert reader.read_block_into(dst[1])
        assert reader.read_block_into(dst[2])
        assert reader.read_block_into(dst[0]) and True  # more available
    os.close(fd)
    ref = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(dst[1], ref[6400:2 * 6400])
    np.testing.assert_array_equal(dst[2], ref[2 * 6400:3 * 6400])


def test_batch_runner_matches_single_station(tmp_path):
    """Two capture files through BatchRunner == each through its own
    single-station receiver, bit-exact, across repeated passes.

    Repetition is the point: a single-staging-buffer BatchRunner raced
    its own in-flight step (jnp.asarray may alias the numpy buffer on
    CPU or still be DMA-ing it on the GPU when the loop refills it) and
    corrupted tens of samples in ~20%% of runs under load.  The runner
    now double-buffers; this test re-runs the whole pipeline several
    times and demands bitwise equality every time."""
    import jax
    import jax.numpy as jnp

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.io.batch import BatchRunner
    from rtsdr_tpu.pipeline.receiver import make_receiver

    n_blocks = 2
    bs = MODE0.block_size
    paths = []
    caps = []
    for i, tone in enumerate((1.1e3, 0.7e3)):
        u8 = synth_multiplex_iq(n_blocks * bs // 2, mono_hz=tone)
        p = tmp_path / f"cap{i}.iq"
        p.write_bytes(u8.tobytes())
        paths.append(str(p))
        caps.append(u8)

    init_fn, step_fn = make_receiver(MODE0, (), jnp.float32,
                                     enable_rds=False)
    step = jax.jit(step_fn)
    ref = {}
    for c in range(2):
        state = init_fn()
        ref[c] = []
        for b in range(n_blocks):
            state, out = step(state,
                              jnp.asarray(caps[c][b * bs:(b + 1) * bs]))
            ref[c].append((np.asarray(out.left), np.asarray(out.right)))

    for trial in range(4):
        got = {0: [], 1: []}
        fds = [os.open(p, os.O_RDONLY) for p in paths]
        with BatchRunner(MODE0, fds, enable_rds=False) as runner:
            stats = runner.run(emit=lambda c, l, r: got[c].append(
                (l.copy(), r.copy())))
        for fd in fds:
            os.close(fd)
        assert stats == {"blocks": n_blocks, "stations": 2}
        for c in range(2):
            for b in range(n_blocks):
                np.testing.assert_array_equal(
                    got[c][b][0], ref[c][b][0], err_msg=f"t{trial} c{c} b{b} L")
                np.testing.assert_array_equal(
                    got[c][b][1], ref[c][b][1], err_msg=f"t{trial} c{c} b{b} R")


def test_block_reader_prefetch(tmp_path):
    data = np.arange(1000, dtype=np.uint8).tobytes() * 30  # 30000 bytes
    f = tmp_path / "stream.bin"
    f.write_bytes(data)
    fd = os.open(str(f), os.O_RDONLY)
    got = []
    with BlockReader(fd, 7000, n_slots=3) as reader:
        while True:
            blk = reader.read_block()
            if blk is None:
                break
            got.append(blk)
    os.close(fd)
    assert len(got) == 4  # 30000 // 7000, partial tail dropped
    ref = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(np.concatenate(got), ref[: 4 * 7000])


def test_block_reader_close_on_stalled_pipe():
    """Destroying the reader while the producer is blocked on an idle pipe
    (no data, writer still open) must not hang: the producer polls with a
    timeout and observes the stop flag."""
    import time

    r_fd, w_fd = os.pipe()
    try:
        reader = BlockReader(r_fd, 4096, n_slots=2)
        time.sleep(0.1)  # let the producer block in poll/read
        t0 = time.perf_counter()
        reader.close()
        assert time.perf_counter() - t0 < 2.0, "close() hung on stalled pipe"
    finally:
        os.close(r_fd)
        os.close(w_fd)


def test_cli_batch_stations(tmp_path):
    """--stations: N capture files decoded as one channel-batched receiver,
    one wav per station."""
    iq = synth_multiplex_iq(307200 // 2)
    f1 = tmp_path / "s1.iq"
    f2 = tmp_path / "s2.iq"
    f1.write_bytes(iq.tobytes())
    f2.write_bytes(iq.tobytes())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(DEFAULT_DIR))
    proc = subprocess.run(
        [sys.executable, "-m", "rtsdr_tpu.cli", "0", "--no-rds",
         "--stations", str(f1), str(f2)],
        capture_output=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=540)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"processed 1 blocks x 2 stations" in proc.stderr
    import wave
    for f in (f1, f2):
        with wave.open(str(f) + ".wav") as w:
            assert w.getnchannels() == 2
            assert w.getnframes() == 3072


def test_cli_end_to_end(tmp_path):
    """Run the CLI as a subprocess on a synthetic station: stdin uint8 ->
    stdout int16 stereo; audio must contain the 1.1 kHz tone."""
    n_blocks = 2
    iq_u8 = synth_multiplex_iq(n_blocks * 307200 // 2)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(DEFAULT_DIR))
    proc = subprocess.run(
        [sys.executable, "-m", "rtsdr_tpu.cli", "0", "--no-rds"],
        input=iq_u8.tobytes(), capture_output=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=540)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    audio = np.frombuffer(proc.stdout, np.int16)
    assert audio.size == n_blocks * 3072 * 2
    left = audio[0::2].astype(np.float64) / 16384.0
    x = left[3072:]  # skip warmup block
    t = np.arange(len(x)) / 48e3
    amp = np.hypot(2 * np.mean(x * np.sin(2 * np.pi * 1.1e3 * t)),
                   2 * np.mean(x * np.cos(2 * np.pi * 1.1e3 * t)))
    expected = 2 * np.pi * 75e3 * 0.45 / 240e3 / 2  # L = (mono+stereo)/2
    assert amp > 0.5 * expected
    assert b"processed 2 blocks" in proc.stderr


def test_cli_auto_scan_then_decode(tmp_path):
    """--auto: scan the first wideband blocks, then decode only the
    slots classified as stations (wavs/RDS output suppressed for empty
    ones) — one command for the reference's scan-retune-listen loop."""
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_scan import _wideband_capture

    k, n_blocks = 2, 5
    raw = _wideband_capture(k, n_blocks, {
        1: dict(rng=np.random.default_rng(3)),   # station in slot 1 only
    })
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(DEFAULT_DIR))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "rtsdr_tpu.cli", "0", "--no-rds",
         "--wideband", str(k), "--auto"],
        input=raw.tobytes(), capture_output=True, env=env,
        cwd=tmp_path, timeout=540)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    table = proc.stdout.decode()
    assert "empty" in table and "station" in table
    assert b"auto: 1/2 slots active" in proc.stderr
    # 3 blocks scanned, 2 decoded; only the live slot gets a wav
    assert b"processed 2 wideband blocks" in proc.stderr
    assert not (tmp_path / "channel0.wav").exists()
    import wave
    with wave.open(str(tmp_path / "channel1.wav")) as w:
        assert w.getnchannels() == 2
        assert w.getnframes() == 2 * 3072


def test_cli_scan_requires_wideband():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "rtsdr_tpu.cli", "0", "--scan"],
        capture_output=True, env=env, stdin=subprocess.DEVNULL,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=120)
    assert proc.returncode == 1
    assert b"--scan requires --wideband" in proc.stderr


def test_block_reader_fallback_short_reads(monkeypatch):
    """The no-native-library fallback must loop on short reads: a pipe
    returns only what is buffered, and FileIO.read issues ONE os.read —
    the old fallback reported mid-stream EOF the first time a block
    exceeded the pipe buffer (every --wideband block does)."""
    import threading

    import rtsdr_tpu.runtime as rt

    monkeypatch.setattr(rt, "_load", lambda: None)
    r_fd, w_fd = os.pipe()
    data = bytes(range(256)) * 1000          # 256,000 bytes
    def writer():
        for i in range(0, len(data), 10_000):   # dribble odd chunks
            os.write(w_fd, data[i:i + 10_000])
        os.close(w_fd)
    t = threading.Thread(target=writer)
    t.start()
    got = []
    with rt.BlockReader(r_fd, 70_000) as reader:
        while True:
            blk = reader.read_block()
            if blk is None:
                break
            got.append(blk)
    t.join()
    os.close(r_fd)
    assert len(got) == 3                       # 256000 // 70000
    np.testing.assert_array_equal(
        np.concatenate(got), np.frombuffer(data[:210_000], np.uint8))


def test_cli_auto_pipe_chunked(tmp_path):
    """--auto over a LIVE PIPE written in odd-sized chunks: the scan
    pass hands the stream to the decode pass mid-flow, so any bytes
    stranded in a buffered reader at the handoff would shift (or
    I/Q-swap) everything the decoder sees.  The station tone surviving
    in its slot proves the handoff is byte-exact."""
    import threading
    import wave

    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_scan import _wideband_capture

    k, n_blocks = 2, 5
    raw = _wideband_capture(k, n_blocks, {
        1: dict(rng=np.random.default_rng(3)),
    }).tobytes()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", str(DEFAULT_DIR))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rtsdr_tpu.cli", "0", "--no-rds",
         "--wideband", str(k), "--auto"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, cwd=tmp_path)

    def feeder():
        for i in range(0, len(raw), 9_973):     # prime-sized chunks
            proc.stdin.write(raw[i:i + 9_973])
        proc.stdin.close()

    t = threading.Thread(target=feeder)
    t.start()
    t.join(timeout=540)   # stdin fully written and closed by the feeder
    proc.stdin = None     # communicate() must not touch the closed pipe
    out, err = proc.communicate(timeout=540)
    assert proc.returncode == 0, err.decode()[-2000:]
    assert b"auto: 1/2 slots active" in err
    assert b"processed 2 wideband blocks" in err
    with wave.open(str(tmp_path / "channel1.wav")) as w:
        frames = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    audio = frames.reshape(-1, 2)[:, 0].astype(np.float64) / 16384.0
    x = audio[3072:]
    tt = np.arange(len(x)) / 48e3
    amp = 2 * np.hypot(np.mean(x * np.sin(2 * np.pi * 1.1e3 * tt)),
                       np.mean(x * np.cos(2 * np.pi * 1.1e3 * tt)))
    assert amp > 0.3, f"tone lost: handoff misaligned the stream ({amp})"
