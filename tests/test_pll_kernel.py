"""GPU PLL kernel (ops/pll_kernel.py) vs the lax.scan reference.

The kernel is Pallas on the Triton route; here it runs with
``interpret=True`` on the CPU, and ``test_kernel_lowers_for_gpu`` lowers
it for CUDA (Triton IR) without a card.  Tolerances: the kernel's
detector is the sign-select identity of the scan's atan2, so outputs
agree to float32 rounding of the loop (~1e-5 over a block; NUMERICS.md).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.ops.pll import pll, pll_init

ATOL = 5e-5
_FOUR_PI = 4 * np.pi
PAIR = dict(freq=np.array([19e3, 114e3]).reshape(2, 1), fs=240e3,
            nco_scale=np.array([2.0, 0.5]).reshape(2, 1),
            phase_adjust=np.array(
                [0.0, math.pi / 3.3 - math.pi / 1.5]).reshape(2, 1),
            norm_bandwidth=np.array([0.01, 0.001]).reshape(2, 1))
PILOT = dict(freq=19e3, fs=240e3, nco_scale=2.0)


def _pilot(n, c=None, f=19e3, fs=240e3):
    t = np.arange(n) / fs
    if c is None:
        return jnp.asarray(np.cos(2 * np.pi * f * t + 0.4), jnp.float32)
    return jnp.asarray(np.stack([np.cos(2 * np.pi * f * t + 0.1 * k)
                                 for k in range(c)]), jnp.float32)


def _kernel(x, st, **kw):
    return pll(x, st, impl="kernel", interpret=True, **kw)


def _scan(x, st, **kw):
    return pll(x, st, impl="scan", **kw)


def _assert_close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours[0]), np.asarray(ref[0]),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(ours[1]), np.asarray(ref[1]),
                               atol=atol)
    for name, a, b in zip(type(ref[2])._fields, ours[2], ref[2]):
        a, b = np.asarray(a), np.asarray(b)
        if name in ("phase_est", "theta"):   # angles mod 4pi
            d = np.abs(a - b) % _FOUR_PI
            a, b = np.minimum(d, _FOUR_PI - d), 0.0 * d
        np.testing.assert_allclose(a, b, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("delay", [True, False])
@pytest.mark.parametrize("div", [1, 2, 4, 8])
def test_kernel_matches_scan(div, delay):
    x = _pilot(1920, 3)
    kw = dict(PILOT, loop_div=div, delay_output=delay)
    _assert_close(_kernel(x, pll_init((3,)), **kw),
                  _scan(x, pll_init((3,)), **kw))


@pytest.mark.parametrize("batch", [(), (1,), (37,), (2, 33)])
def test_kernel_lane_counts(batch):
    """Lane counts that are not a multiple of the 32-lane program: the
    last program masks its tail."""
    c = math.prod(batch)
    x = _pilot(960, c).reshape(*batch, 960)
    _assert_close(_kernel(x, pll_init(batch), **PILOT),
                  _scan(x, pll_init(batch), **PILOT))


@pytest.mark.parametrize("div", [1, 2, 4])
def test_kernel_state_chains_over_blocks(div):
    """Four chained blocks through the kernel == one scan over all."""
    x = _pilot(3840)
    kw = dict(PILOT, loop_div=div)
    ref = _scan(x, pll_init(()), **kw)
    st, outs = pll_init(()), []
    for b in range(4):
        oi, _, st = _kernel(x[b * 960:(b + 1) * 960], st, **kw)
        outs.append(np.asarray(oi))
    np.testing.assert_allclose(np.concatenate(outs), np.asarray(ref[0]),
                               atol=ATOL)


@pytest.mark.parametrize("n", [16000, 1921, 1924])
def test_kernel_block_lengths(n):
    """The mode-1 block (16000) and lengths with a tail shorter than the
    kernel's 8-sample tile."""
    x = _pilot(n, fs=250e3)
    kw = dict(PILOT, fs=250e3)
    ours, ref = _kernel(x, pll_init(()), **kw), _scan(x, pll_init(()), **kw)
    np.testing.assert_allclose(np.asarray(ours[0]), np.asarray(ref[0]),
                               atol=ATOL)


def test_kernel_fused_pair_per_lane_constants():
    """The receiver's stereo-pilot + RDS-carrier pair: one call, per-lane
    loop constants, against the scan."""
    c, n = 5, 1920
    t = np.arange(n) / 240e3
    x = jnp.asarray(np.stack(
        [np.stack([np.cos(2 * np.pi * f * t + 0.2 * k) for k in range(c)])
         for f in (19e3, 114e3)]), jnp.float32)
    _assert_close(_kernel(x, pll_init((2, c)), **PAIR),
                  _scan(x, pll_init((2, c)), **PAIR))


def test_kernel_tuple_input_matches_stacked():
    a, b = _pilot(1920, 4), _pilot(1920, 4, f=114e3)
    ref = _kernel(jnp.stack([a, b]), pll_init((2, 4)), **PAIR)
    tup = _kernel((a, b), pll_init((2, 4)), **PAIR)
    for x, y in zip(jax.tree.leaves(tup), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_kernel_tuple_shape_mismatch_raises():
    with pytest.raises(ValueError, match="equal shapes"):
        _kernel((jnp.zeros((4, 960)), jnp.zeros((8, 960))),
                pll_init((2, 4)), **PILOT)


@pytest.mark.parametrize("div,n", [(3, 960), (4, 962)])
def test_kernel_rejects_loop_div(div, n):
    """A loop_div the kernel cannot take is an error, never a silent
    switch to the scan."""
    with pytest.raises(ValueError, match="loop_div"):
        _kernel(_pilot(n), pll_init(()), loop_div=div, **PILOT)


@pytest.mark.parametrize("div", [1, 8])
def test_kernel_lowers_for_gpu(div):
    """The kernel lowers through Pallas' Triton route for CUDA at the
    fleet width (2 x 1024 lanes, one mode-0 block) — no card needed."""
    from rtsdr_tpu.ops.pll_kernel import pll_args

    x = jax.ShapeDtypeStruct((2048, 15360), jnp.float32)
    par = jax.ShapeDtypeStruct((3, 2048), jnp.float32)
    st = jax.ShapeDtypeStruct((4, 2048), jnp.float32)
    lowered = jax.jit(lambda x, p, s: pll_args(x, p, s, loop_div=div)).trace(
        x, par, st).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text().lower()
