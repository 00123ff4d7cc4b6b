"""Banded-matmul conv formulation vs the XLA conv reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.ops.coeffs import lowpass_taps
from rtsdr_tpu.ops.fir import _conv1d_valid_matmul, _conv1d_valid_xla


@pytest.mark.parametrize("stride,n", [(1, 15360), (1, 1000), (5, 15360),
                                      (10, 153600), (80, 291840), (3, 299)])
def test_matmul_conv_matches_xla(rng, stride, n):
    taps = 151
    h = lowpass_taps(240e3, 16e3, taps)
    x = rng.standard_normal((3, n + taps - 1))
    ref = np.asarray(_conv1d_valid_xla(jnp.asarray(x), jnp.asarray(h), stride))
    ours = np.asarray(_conv1d_valid_matmul(jnp.asarray(x), jnp.asarray(h),
                                           stride))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("up,down,n,taps", [
    (19, 80, 15360, 151),    # RDS resampler
    (24, 125, 16000, 3624),  # mode-1 audio resampler
    (3, 7, 1400, 45),
    (5, 2, 200, 31),
])
def test_polyphase_matmul_matches_u_domain(rng, up, down, n, taps):
    """The x-domain polyphase matmul must equal the u-domain reference
    exactly, including the zi boundary terms and the carried state."""
    from rtsdr_tpu.ops.fir import (
        _resample_polyphase_matmul,
        fir_resample,
        resample_zi,
    )
    import jax

    h = np.sin(np.arange(taps) * 0.37) / taps  # arbitrary full-band taps
    x1 = rng.standard_normal((2, n))
    x2 = rng.standard_normal((2, n))

    # reference: u-domain chain over two blocks (fir_resample on CPU)
    zi = resample_zi(taps, (2,), jnp.float64)
    ref1, zi_ref = fir_resample(jnp.asarray(x1), h, zi, up, down)
    ref2, zi_ref2 = fir_resample(jnp.asarray(x2), h, zi_ref, up, down)

    zi = resample_zi(taps, (2,), jnp.float64)
    o1, zi_o = _resample_polyphase_matmul(jnp.asarray(x1), jnp.asarray(h),
                                          zi, up, down)
    o2, zi_o2 = _resample_polyphase_matmul(jnp.asarray(x2), jnp.asarray(h),
                                           zi_o, up, down)
    np.testing.assert_allclose(np.asarray(o1) * up, np.asarray(ref1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(zi_o), np.asarray(zi_ref))
    np.testing.assert_allclose(np.asarray(o2) * up, np.asarray(ref2),
                               rtol=1e-12, atol=1e-12)


def test_matmul_conv_f32(rng):
    h = lowpass_taps(240e3, 16e3, 151).astype(np.float32)
    x = rng.standard_normal((2, 2, 15510)).astype(np.float32)
    ref = np.asarray(_conv1d_valid_xla(jnp.asarray(x), jnp.asarray(h), 1))
    ours = np.asarray(_conv1d_valid_matmul(jnp.asarray(x), jnp.asarray(h), 1))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


def test_multi_filter_matmul_matches_individual(rng):
    """Stacked F-filter banded matmul == per-filter matmuls exactly."""
    from rtsdr_tpu.ops.fir import _conv1d_valid_multi_matmul

    taps = 151
    hs = [lowpass_taps(240e3, 16e3, taps),
          lowpass_taps(240e3, 3e3, taps),
          np.sin(np.arange(taps) * 0.7) / taps]
    xext = rng.standard_normal((3, 15360 + taps - 1))
    got = np.asarray(_conv1d_valid_multi_matmul(
        jnp.asarray(xext), jnp.stack([jnp.asarray(h) for h in hs])))
    assert got.shape == (3, 3, 15360)
    for f, h in enumerate(hs):
        ref = np.asarray(_conv1d_valid_matmul(jnp.asarray(xext),
                                              jnp.asarray(h)))
        np.testing.assert_allclose(got[:, f], ref, rtol=1e-12, atol=1e-12)


def test_fir_block_multi_state_chain(rng):
    """fir_block_multi == F separate fir_block chains, including state."""
    from rtsdr_tpu.ops.fir import fir_block, fir_block_multi, fir_zi

    taps = 151
    hs = [lowpass_taps(240e3, 16e3, taps),
          np.cos(np.arange(taps) * 0.3) / taps]
    x1 = rng.standard_normal((2, 2000))
    x2 = rng.standard_normal((2, 2000))

    zi = fir_zi(taps, (2,), jnp.float64)
    y1, zi1 = fir_block_multi(jnp.asarray(x1), hs, zi)
    y2, zi2 = fir_block_multi(jnp.asarray(x2), hs, zi1)

    for f, h in enumerate(hs):
        zr = fir_zi(taps, (2,), jnp.float64)
        r1, zr1 = fir_block(jnp.asarray(x1), h, zr)
        r2, zr2 = fir_block(jnp.asarray(x2), h, zr1)
        np.testing.assert_allclose(np.asarray(y1[:, f]), np.asarray(r1),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(y2[:, f]), np.asarray(r2),
                                   atol=1e-12)
        np.testing.assert_array_equal(np.asarray(zi2), np.asarray(zr2))


@pytest.mark.parametrize("cfg_name,which", [
    ("MODE0", "rds"),          # x19/80, 3001-tap composed filter
    ("MODE1", "audio"),        # x24/125, 3624 taps
    ("MODE1_RDS", "rds"),      # x57/250, 9003-tap composed filter
])
def test_resampler_f32_matches_f64_oracle(rng, cfg_name, which):
    """The float32 production resampler (x-domain polyphase matmul) vs
    the float64 oracle (dilated conv over the zero-stuffed stream), over
    two chained blocks at the receiver's geometries.  Bound: float32
    rounding of a unit-gain filter on unit-variance input."""
    from rtsdr_tpu import config
    from rtsdr_tpu.ops.fir import fir_resample, resample_zi
    from rtsdr_tpu.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu.pipeline.rds import composed_resampler_taps

    cfg = getattr(config, cfg_name)
    if which == "rds":
        h, up, down = composed_resampler_taps(cfg), cfg.rds.up, cfg.rds.down
    else:
        h, up, down = audio_lpf_taps(cfg), cfg.mono.up, cfg.mono.down
    n = cfg.if_len
    xs = [rng.standard_normal((2, n)) for _ in range(2)]
    outs = {}
    for dtype in (jnp.float32, jnp.float64):
        zi = resample_zi(len(h), (2,), dtype)
        ys = []
        for x in xs:
            y, zi = fir_resample(jnp.asarray(x, dtype), h, zi, up, down)
            ys.append(np.asarray(y, np.float64))
        outs[dtype] = np.concatenate(ys, axis=-1)
    assert outs[jnp.float32].shape == (2, 2 * n * up // down)
    np.testing.assert_allclose(outs[jnp.float32], outs[jnp.float64],
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("pre", ["square", "mul2"])
def test_pre_op_fir_f32_matches_f64_oracle(rng, pre):
    """The elementwise pre-ops that feed a FIR (squared RDS band-pass,
    stereo mixer into the LPF decimate-by-5) as plain XLA composition:
    float32 production path vs the float64 conv oracle."""
    from rtsdr_tpu.ops.fir import fir_decimate, fir_zi

    h = lowpass_taps(240e3, 16e3, 151)
    x, nco = rng.standard_normal((2, 3, 15360)), rng.standard_normal((3, 15360))
    outs = {}
    for dtype in (jnp.float32, jnp.float64):
        a = jnp.asarray(x[0], dtype)
        xp = a * a if pre == "square" else 2.0 * a * jnp.asarray(nco, dtype)
        decim = 1 if pre == "square" else 5
        y, _ = fir_decimate(xp, h, fir_zi(151, (3,), dtype), decim)
        outs[dtype] = np.asarray(y, np.float64)
    np.testing.assert_allclose(outs[jnp.float32], outs[jnp.float64],
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("block", [8, 32, 128, 256])
def test_matmul_conv_any_block(rng, block):
    """The banded matmul is exact for any row-block size (the block only
    trades im2col bytes against banded FLOPs)."""
    h = lowpass_taps(240e3, 16e3, 151)
    x = rng.standard_normal((2, 3000 + 150))
    for stride in (1, 5):
        ref = np.asarray(_conv1d_valid_xla(jnp.asarray(x), jnp.asarray(h),
                                           stride))
        ours = np.asarray(_conv1d_valid_matmul(
            jnp.asarray(x), jnp.asarray(h), stride, block=block))
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
