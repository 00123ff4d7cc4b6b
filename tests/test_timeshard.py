"""Time-block sharding must equal the serial receiver.

Runs on the virtual 8-device CPU mesh; halo exchange + pipelined PLL
handoff reproduce serial overlap-save semantics exactly (SURVEY.md §7 hard
part #2).  The float32 FIRs and resamplers are banded matmuls
(ops/paths.py), and a matmul backend picks its summation order by shape:
XLA's CPU dot changes kernel below ~96 rows, cuBLAS changes algorithm by
shape on the GPU.  A time shard's matmuls have fewer rows than the serial
one's, so float outputs agree to float32 rounding of a 151-tap dot
(``F32_ATOL``, the bound the blend test below already uses for its
reduction order), and every decision — RDS syndromes, sync — is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.config import MODE0, MODE1
from rtsdr_tpu.parallel.mesh import make_mesh
from rtsdr_tpu.parallel.channels import make_channel_sharded_receiver
from rtsdr_tpu.parallel.timeshard import make_time_sharded_receiver
from rtsdr_tpu.pipeline.receiver import make_receiver

from oracles import synth_multiplex_iq


N_BLOCKS = 2
F32_ATOL = 2e-6


def _assert_f32_equal(ours, ref, **kw):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=0,
                               atol=F32_ATOL, **kw)


@pytest.fixture(scope="module")
def station_u8():
    return synth_multiplex_iq(N_BLOCKS * MODE0.block_size // 2)


def _run_serial(cfg, raw, n_channels, n_blocks, dtype=jnp.float32, **kw):
    init_fn, step_fn = make_receiver(cfg, (n_channels,), dtype, **kw)
    state = init_fn()
    step = jax.jit(step_fn)
    outs = []
    bs = cfg.block_size
    for b in range(n_blocks):
        blk = jnp.asarray(np.stack([raw[b * bs:(b + 1) * bs]] * n_channels))
        state, out = step(state, blk)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("t_shards,ch_shards,deemph", [
    (2, 1, None), (4, 2, None), (8, 1, None),
    # feature parity: de-emphasis must survive the move onto a mesh
    # (runs replicated at the 48 kS/s rate after an all_gather)
    (4, 2, 75e-6), (8, 1, 50e-6),
])
def test_time_sharded_equals_serial(station_u8, t_shards, ch_shards, deemph):
    n_channels = 2 * ch_shards
    mesh = make_mesh(ch_shards, t_shards)
    init_fn, step_fn = make_time_sharded_receiver(
        MODE0, mesh, n_channels, jnp.float32, deemphasis=deemph)
    state = init_fn()

    ser_state, ser_outs = _run_serial(MODE0, station_u8, n_channels, N_BLOCKS,
                                      deemphasis=deemph)

    bs = MODE0.block_size
    for b in range(N_BLOCKS):
        blk = jnp.asarray(
            np.stack([station_u8[b * bs:(b + 1) * bs]] * n_channels))
        state, out = step_fn(state, blk)
        ref = ser_outs[b]
        _assert_f32_equal(out.left, ref.left, err_msg=f"b{b} L")
        _assert_f32_equal(out.right, ref.right, err_msg=f"b{b} R")
        np.testing.assert_array_equal(np.asarray(out.rds.syndrome_id),
                                      np.asarray(ref.rds.syndrome_id))
        _assert_f32_equal(out.rds.symbols_i, ref.rds.symbols_i)

    # carried state equal too
    for ours, ref in zip(jax.tree.leaves(state), jax.tree.leaves(ser_state)):
        _assert_f32_equal(ours, ref)


def test_time_sharded_equals_serial_f64_bitwise(station_u8):
    """In float64 every stage runs the conv/scan oracle paths, whose sums
    do not depend on how many rows a shard holds: there the halo exchange
    and PLL handoff reproduce the serial receiver bit for bit."""
    mesh = make_mesh(1, 4)
    init_fn, step_fn = make_time_sharded_receiver(MODE0, mesh, 1,
                                                  jnp.float64)
    state = init_fn()
    ser_state, ser_outs = _run_serial(MODE0, station_u8, 1, N_BLOCKS,
                                      dtype=jnp.float64)
    bs = MODE0.block_size
    for b in range(N_BLOCKS):
        state, out = step_fn(state, jnp.asarray(station_u8[None,
                                                           b * bs:(b + 1) * bs]))
        for name in ("left", "right"):
            np.testing.assert_array_equal(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ser_outs[b], name)), err_msg=f"b{b} {name}")
        np.testing.assert_array_equal(np.asarray(out.rds.syndrome_id),
                                      np.asarray(ser_outs[b].rds.syndrome_id))
    for ours, ref in zip(jax.tree.leaves(state), jax.tree.leaves(ser_state)):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))


def test_time_sharded_mode1(station_u8):
    iq = synth_multiplex_iq(N_BLOCKS * MODE1.block_size // 2, rf_fs=2.5e6)
    mesh = make_mesh(2, 4)
    init_fn, step_fn = make_time_sharded_receiver(MODE1, mesh, 2, jnp.float32)
    state = init_fn()
    ser_state, ser_outs = _run_serial(MODE1, iq, 2, N_BLOCKS)
    bs = MODE1.block_size
    for b in range(N_BLOCKS):
        blk = jnp.asarray(np.stack([iq[b * bs:(b + 1) * bs]] * 2))
        state, out = step_fn(state, blk)
        _assert_f32_equal(out.left, ser_outs[b].left)


def test_time_sharded_mode1_rds(station_u8):
    """MODE1_RDS (x57/250 RDS path) on the mesh: the new config's rds_len
    (3648) and symbol grid must survive the time split bit-for-bit."""
    from rtsdr_tpu.config import MODE1_RDS

    iq = synth_multiplex_iq(N_BLOCKS * MODE1_RDS.block_size // 2,
                            rf_fs=2.5e6)
    mesh = make_mesh(2, 4)
    init_fn, step_fn = make_time_sharded_receiver(MODE1_RDS, mesh, 2,
                                                  jnp.float32)
    state = init_fn()
    ser_state, ser_outs = _run_serial(MODE1_RDS, iq, 2, N_BLOCKS)
    bs = MODE1_RDS.block_size
    for b in range(N_BLOCKS):
        blk = jnp.asarray(np.stack([iq[b * bs:(b + 1) * bs]] * 2))
        state, out = step_fn(state, blk)
        _assert_f32_equal(out.left, ser_outs[b].left)
        np.testing.assert_array_equal(np.asarray(out.rds.syndrome_id),
                                      np.asarray(ser_outs[b].rds.syndrome_id))


def test_time_sharded_blend_and_ec_match_serial():
    """Deployment-shape feature parity (round-5): ``stereo_blend`` and
    ``error_correct`` must behave identically on the time-sharded mesh.

    The pilot amplitude is chosen INSIDE the blend ramp (lo=0.02,
    hi=0.08 pilot-RMS) so the psum-reduced pilot power actually scales
    the stereo difference signal.  Blend audio is allclose (the full-
    block pilot-RMS mean is reduced in a different grouping — psum of
    per-shard partials — so bitwise equality is not guaranteed); the
    frame layer (incl. the EC 'corrected' column) is exact: it runs
    replicated on the all_gathered 57 kS/s stream."""
    n_blocks = 3
    raw = synth_multiplex_iq(n_blocks * MODE0.block_size // 2,
                             pilot_amp=0.04)
    kw = dict(stereo_blend=True, error_correct=True)
    _, ser_outs = _run_serial(MODE0, raw, 2, n_blocks, **kw)

    mesh = make_mesh(1, 4)
    init_fn, step_fn = make_time_sharded_receiver(MODE0, mesh, 2,
                                                  jnp.float32, **kw)
    state = init_fn()
    bs = MODE0.block_size
    for b in range(n_blocks):
        blk = jnp.asarray(np.stack([raw[b * bs:(b + 1) * bs]] * 2))
        state, out = step_fn(state, blk)
        ref = ser_outs[b]
        np.testing.assert_allclose(np.asarray(out.left),
                                   np.asarray(ref.left),
                                   rtol=0, atol=2e-6, err_msg=f"b{b} L")
        np.testing.assert_allclose(np.asarray(out.right),
                                   np.asarray(ref.right),
                                   rtol=0, atol=2e-6, err_msg=f"b{b} R")
        # blend must actually attenuate: at pilot_amp=0.04 the stereo
        # difference is scaled by ~(rms-lo)/(hi-lo) < 1, so L != R proves
        # stereo survives while |L-R| shrinks vs the unblended run
        np.testing.assert_array_equal(np.asarray(out.rds.syndrome_id),
                                      np.asarray(ref.rds.syndrome_id))
        np.testing.assert_array_equal(np.asarray(out.rds.corrected),
                                      np.asarray(ref.rds.corrected))
        np.testing.assert_array_equal(np.asarray(out.rds.is_sync),
                                      np.asarray(ref.rds.is_sync))


def test_channel_sharded_equals_serial(station_u8):
    mesh = make_mesh(8, 1)
    init_fn, step_fn, _ = make_channel_sharded_receiver(MODE0, mesh, 8,
                                                        jnp.float32)
    state = init_fn()
    ser_state, ser_outs = _run_serial(MODE0, station_u8, 8, 1)
    bs = MODE0.block_size
    blk = jnp.asarray(np.stack([station_u8[:bs]] * 8))
    state, out = step_fn(state, blk)
    np.testing.assert_array_equal(np.asarray(out.left),
                                  np.asarray(ser_outs[0].left))
    np.testing.assert_array_equal(np.asarray(out.rds.syndrome_id),
                                  np.asarray(ser_outs[0].rds.syndrome_id))


def test_fused_ingest_halo_consistency(station_u8):
    """The uint8 ingest + RF front end on a time mesh: the halo exchange
    must reproduce the unsharded (T=1) run across blocks."""
    outs = {}
    for t_shards in (1, 4):
        mesh = make_mesh(1, t_shards)
        init_fn, step_fn = make_time_sharded_receiver(
            MODE0, mesh, 2, jnp.float32)
        state = init_fn()
        res = []
        bs = MODE0.block_size
        for b in range(N_BLOCKS):
            blk = jnp.asarray(
                np.stack([station_u8[b * bs:(b + 1) * bs]] * 2))
            state, out = step_fn(state, blk)
            res.append(out)
        outs[t_shards] = (res, jax.tree.leaves(state))

    for b in range(N_BLOCKS):
        _assert_f32_equal(outs[4][0][b].left, outs[1][0][b].left,
                          err_msg=f"block {b}")
        np.testing.assert_array_equal(
            np.asarray(outs[4][0][b].rds.syndrome_id),
            np.asarray(outs[1][0][b].rds.syndrome_id))
    for a, bb in zip(outs[4][1], outs[1][1]):
        _assert_f32_equal(a, bb)


@pytest.mark.parametrize("handoff,snr_floor_db", [
    ("stale", 38.0),     # measured post-lock floor ~45 dB (blocks 1-6)
    ("iterate", 60.0),   # measured ~132 dB — float32-exact vs serial
])
def test_concurrent_pll_handoff_converges_to_serial(handoff, snr_floor_db):
    """pll_handoff='stale' trades bit-exactness for T-linear PLL latency:
    each shard seeds from the exact previous-block carry extrapolated by
    its own offset (ops/pll.py::pll_extrapolate_by).  'iterate' adds one
    same-block refinement pass and is float32-indistinguishable from the
    serial receiver after lock.  Audio must agree within the quality bar,
    RDS must still frame-sync."""
    from oracles import encode_rds_blocks, rds_baseband

    n_blocks = 5
    rng = np.random.default_rng(11)
    bits = encode_rds_blocks(rng.integers(0, 2, size=(40 * n_blocks, 16)))
    raw = synth_multiplex_iq(n_blocks * MODE0.block_size // 2,
                             rds_wave=rds_baseband(bits), rng=rng)

    _, ser_outs = _run_serial(MODE0, raw, 1, n_blocks)

    mesh = make_mesh(1, 4)
    init_fn, step_fn = make_time_sharded_receiver(
        MODE0, mesh, 1, jnp.float32, pll_handoff=handoff)
    state = init_fn()
    bs = MODE0.block_size
    outs = []
    for b in range(n_blocks):
        blk = jnp.asarray(raw[b * bs:(b + 1) * bs][None])
        state, out = step_fn(state, blk)
        outs.append(out)

    # block 0 is acquisition (both receivers pre-lock); compare the rest.
    # stale: the loop's phase random-walk over the <=(T-1)/T-block
    # staleness re-converges at each chunk start; measured floor ~45 dB —
    # well inside FM broadcast stereo-separation tolerances.
    for b in range(1, n_blocks):
        ref = np.asarray(ser_outs[b].left[0])
        got = np.asarray(outs[b].left[0])
        err = np.sqrt(np.mean((got - ref) ** 2))
        sig = np.sqrt(np.mean(ref ** 2))
        snr_db = 20 * np.log10(sig / max(err, 1e-30))
        assert snr_db > snr_floor_db, (
            f"block {b}: {handoff} audio SNR {snr_db:.1f} dB")

    # RDS chain still locks: syncs fire in the final blocks
    n_sync = sum(int(np.asarray(outs[b].rds.is_sync)
                     [0, : int(outs[b].rds.n_windows[0])].sum())
                 for b in range(n_blocks - 2, n_blocks))
    assert n_sync > 0, f"no RDS frame syncs under {handoff} PLL handoff"


def test_iterate_handoff_with_loop_div_detuned():
    """Regression: the concurrent-handoff seed extrapolation must scale
    the integrator slope by 1/loop_div (the loop filter updates once per
    loop_div samples) — with a detuned pilot (integrator != 0) a
    full-rate slope would mis-seed every shard.  iterate + loop_div=4 on
    a +60 Hz-detuned station must stay float32-exact vs the serial
    receiver built with the same loop_div."""
    from oracles import encode_rds_blocks, rds_baseband

    n_blocks = 4
    rng = np.random.default_rng(11)
    bits = encode_rds_blocks(rng.integers(0, 2, size=(40 * n_blocks, 16)))
    raw = synth_multiplex_iq(n_blocks * MODE0.block_size // 2,
                             rds_wave=rds_baseband(bits),
                             pilot_hz=19e3 + 60.0, rng=rng)
    bs = MODE0.block_size

    init_fn, step_fn = make_receiver(MODE0, (1,), jnp.float32,
                                     pll_loop_div=4)
    st = init_fn()
    step = jax.jit(step_fn)
    ser = []
    for b in range(n_blocks):
        st, out = step(st, jnp.asarray(raw[b * bs:(b + 1) * bs][None]))
        ser.append(np.asarray(out.left[0]))

    mesh = make_mesh(1, 4)
    ifn, sfn = make_time_sharded_receiver(MODE0, mesh, 1, jnp.float32,
                                          pll_handoff="iterate",
                                          pll_loop_div=4)
    s = ifn()
    for b in range(n_blocks):
        s, out = sfn(s, jnp.asarray(raw[b * bs:(b + 1) * bs][None]))
        if b == 0:
            continue  # acquisition
        got = np.asarray(out.left[0])
        err = np.sqrt(np.mean((got - ser[b]) ** 2))
        sig = np.sqrt(np.mean(ser[b] ** 2))
        snr_db = 20 * np.log10(sig / max(err, 1e-30))
        assert snr_db > 60, f"block {b}: SNR {snr_db:.1f} dB"
