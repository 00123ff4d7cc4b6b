"""Time-block sharded receiver: sequence parallelism over the sample stream.

The reference scales the infinite sample stream by serial block streaming
with overlap-save state carry (SURVEY.md §5 "long-context").  Here one
block is additionally split into T chunks across the mesh's ``t`` axis:

  * every FIR/resampler's carried state is the last ``taps-1`` input-domain
    samples — pure data — so chunk t's state is chunk t-1's input tail,
    exchanged with one small ``ppermute`` per stage (the halo-exchange
    analog of ring/context parallelism; ~150 floats x channels per hop);
  * the FM discriminator's 1-sample state is the same pattern on the IF
    stream;
  * the PLL recurrence cannot be data-parallelized exactly, so its state
    pipelines shard-to-shard: at micro-step k only shard k runs its scan
    (``lax.cond``), then hands the loop state to shard k+1 via
    ``ppermute`` — pipeline parallelism with the same total scan latency
    as serial, leaving the FIR-dominated FLOPs fully parallel;
  * the tiny RDS bit layer runs replicated after an ``all_gather`` of the
    57 kS/s RRC chunks.

Outputs and updated state equal the serial receiver's — bit for bit in
float64, to float32 rounding in float32, where a matmul's summation order
depends on how many rows a shard holds (`tests/test_timeshard.py`) — so
time sharding is purely a deployment choice.  Every stage runs the same op, chosen the same way
(``ops.paths.choose``), as the serial receiver.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.demod import fm_discriminator
from rtsdr_tpu.ops.fir import (
    _upsampled_tail_of,
    fir_block,
    fir_decimate,
    fir_resample,
)
from rtsdr_tpu.ops.iir import deemphasize
from rtsdr_tpu.ops.pll import pll, pll_extrapolate_by
from rtsdr_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS
from rtsdr_tpu.pipeline.audio import AudioState
from rtsdr_tpu.pipeline.frame import make_frame
from rtsdr_tpu.pipeline.frontend import FrontendState
from rtsdr_tpu.pipeline.rds import RDSState
from rtsdr_tpu.pipeline.receiver import (
    ReceiverOutputs,
    ReceiverState,
    make_receiver,
)


def make_time_sharded_receiver(
    cfg: ReceiverConfig,
    mesh: Mesh,
    n_channels: int,
    dtype=jnp.float32,
    *,
    enable_rds: bool | None = None,
    enable_frame: bool = True,
    offset_mode: str = "hold",
    use_abs_clock: bool = False,
    resync: bool = False,
    deemphasis: float | None = None,
    pll_handoff: str = "exact",
    pll_loop_div: int = 1,
    error_correct: bool = False,
    stereo_blend: bool | tuple = False,
    derotate: bool = False,
):
    """Build ``(init_fn, step_fn)`` sharded over (channel, time).

    raw input: (n_channels, block_size) uint8, sharded P(ch, t).
    State replicated over t, sharded over ch.  Outputs: audio P(ch, t);
    frame outputs replicated over t.

    ``pll_handoff``:
      * ``'exact'`` (default): the PLL state pipelines shard-to-shard
        within the step (``pll_chain``) — equal to the serial
        receiver, but the loop's wall-time does not shrink with T (an
        Amdahl term).
      * ``'stale'``: every shard scans its chunk concurrently, seeded from
        the exact end-of-previous-block carry (replicated on every shard)
        extrapolated at the locked slope across the shard's own start
        offset ``k*chunk`` (``ops/pll.py::pll_extrapolate_by``) — max
        staleness (T-1)/T of a block, shard 0 exact.  PLL wall-time drops
        to 1/T — near-linear latency scaling — at the cost of a
        lock-transient approximation instead of bit-exactness (in lock the
        seed error is the loop's phase random-walk over the staleness gap;
        the loop re-converges within ~1/bandwidth samples of each chunk
        start).
      * ``'iterate'``: one refinement pass on top of ``'stale'``: after
        the concurrent pass, shard k re-scans seeded from shard k-1's
        *same-block* pass-1 end state (one ``ppermute``), which has
        already re-converged to the sequential trajectory by its chunk
        end.  Near-serial quality at 2/T the serial PLL wall-time.
    """
    if enable_rds is None:
        enable_rds = cfg.rds is not None
    blend_range = None
    if stereo_blend:
        # same thresholds/semantics as the serial receiver
        # (pipeline/audio.py make_audio); the pilot-RMS reduction runs as
        # a psum of per-shard partial sums over the time axis, so the
        # blend factor is replicated and every shard scales its own chunk
        blend_range = (0.02, 0.08) if stereo_blend is True else stereo_blend
        if not blend_range[1] > blend_range[0]:
            raise ValueError(
                f"stereo_blend thresholds need hi > lo, got {blend_range}")
    assert pll_handoff in ("exact", "stale", "iterate")
    concurrent_pll = pll_handoff != "exact"
    pll_passes = {"exact": 0, "stale": 1, "iterate": 2}[pll_handoff]
    assert (cfg.if_len // mesh.shape[TIME_AXIS]) % pll_loop_div == 0

    T = mesh.shape[TIME_AXIS]
    n_ch_shards = mesh.shape[CHANNEL_AXIS]
    assert n_channels % n_ch_shards == 0
    assert cfg.block_size % (2 * cfg.rf.decim * T) == 0
    chunk_if = cfg.if_len // T
    assert (chunk_if * cfg.mono.up) % cfg.mono.down == 0, (
        "audio chunk not divisible; pick T dividing the resampler grid")
    if enable_rds:
        assert (chunk_if * cfg.rds.up) % cfg.rds.down == 0

    # single-device reference init (state layout identical)
    serial_init, serial_step = make_receiver(
        cfg, (n_channels,), dtype, enable_rds=enable_rds,
        enable_frame=enable_frame, offset_mode=offset_mode,
        use_abs_clock=use_abs_clock, deemphasis=deemphasis,
        error_correct=error_correct, stereo_blend=stereo_blend,
        derotate=derotate)

    # coefficients (host constants, closed over)
    rf_h = coeffs.lowpass_taps(cfg.rf.fs, cfg.rf.fc, cfg.rf.taps)
    up, down = cfg.mono.up, cfg.mono.down
    a_taps = cfg.mono.taps * up
    audio_h = coeffs.lowpass_taps(cfg.rf.if_fs * up, cfg.mono.fc, a_taps)
    pilot_h = coeffs.bandpass_taps(cfg.rf.if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    chan_h = coeffs.bandpass_taps(cfg.rf.if_fs, cfg.stereo.chan_lo,
                                  cfg.stereo.chan_hi, cfg.stereo.taps)
    if enable_rds:
        r = cfg.rds
        extract_h = coeffs.bandpass_taps(cfg.rf.if_fs, r.extract_lo,
                                         r.extract_hi, r.taps)
        squared_h = coeffs.bandpass_taps(cfg.rf.if_fs, r.squared_lo,
                                         r.squared_hi, r.taps)
        # 3 kHz LPF composed into the x19 anti-image filter (one polyphase
        # pass — same filter the serial receiver uses, pipeline/rds.py)
        from rtsdr_tpu.pipeline.rds import composed_resampler_taps
        comb_h = composed_resampler_taps(cfg)
        comb_taps = (r.taps - 1) * r.up + r.anti_img_taps
        rrc_h = coeffs.rrc_taps(r.rrc_fs, r.rrc_taps, r.rrc_beta,
                                r.symbol_rate)
        frame_fn = None
        if enable_frame:
            frame_fn = jax.vmap(make_frame(cfg, offset_mode=offset_mode,
                                           use_abs_clock=use_abs_clock,
                                           resync=resync,
                                           error_correct=error_correct,
                                           derotate=derotate))

    def shard_body(state, raw_u8: jax.Array):
        t_id = lax.axis_index(TIME_AXIS)
        perm_right = [(i, i + 1) for i in range(T - 1)]

        def send_right(x):
            if T == 1:
                return jnp.zeros_like(x)
            return lax.ppermute(x, TIME_AXIS, perm_right)

        def first_or(carried, received):
            return jnp.where(t_id == 0, carried, received)

        def from_last(x):
            if T == 1:
                return x
            return lax.psum(jnp.where(t_id == T - 1, x, jnp.zeros_like(x)),
                            TIME_AXIS)

        def halo_fir(op, x, h, carried_zi, *args, tail=None, **kw):
            """Run a stateful FIR op with its zi haloed from the left
            neighbor; returns (y, replicated new global zi)."""
            local_tail = x[..., -carried_zi.shape[-1]:] if tail is None else tail
            zi_eff = first_or(carried_zi, send_right(local_tail))
            y, zi_out = op(x, h, zi_eff, *args, **kw)
            return y, from_last(zi_out)

        def pll_chain(x, pll_state, **params):
            if concurrent_pll:
                # Fresh-carry seeding: shard k's chunk starts k*chunk PLL
                # samples after the exact end-of-previous-block carry
                # (replicated on every shard), so extrapolate the carry by
                # each shard's own offset at the locked slope — staleness
                # is k*chunk <= (T-1)/T of a block (vs a full block for a
                # neighbor-previous-block handoff) and shard 0 is exact,
                # with no cross-step handoff state at all.  The ramp
                # advances are float64 host tables indexed by t_id.
                n_c = x.shape[-1]
                dth64 = (2.0 * math.pi * np.float64(params["freq"])
                         / np.float64(params["fs"]))
                adv_tab = np.mod(dth64 * np.arange(T) * n_c, 4.0 * math.pi)
                # the loop filter adds the integrator once per loop_div
                # samples (ops/pll.py), so the locked phase slope over
                # n samples is (n/loop_div)*integrator
                ns_tab = (np.arange(T, dtype=np.float64) * n_c
                          / params.get("loop_div", 1))
                seed = pll_extrapolate_by(
                    pll_state,
                    jnp.asarray(adv_tab, dtype)[t_id],
                    jnp.asarray(ns_tab, dtype)[t_id],
                    nco_scale=params["nco_scale"],
                    phase_adjust=params["phase_adjust"])
                start = jax.tree.map(first_or, pll_state, seed)
                for p in range(pll_passes):
                    nco_i, nco_q, end = pll(x, start, **params)
                    if p + 1 < pll_passes:
                        # refinement: re-seed shard k from shard k-1's
                        # SAME-BLOCK end state (already re-converged to
                        # the sequential trajectory by its chunk end)
                        recv = jax.tree.map(send_right, end)
                        start = jax.tree.map(first_or, pll_state, recv)
                final = jax.tree.map(from_last, end)
                return nco_i, nco_q, final
            nco_i = jnp.zeros_like(x)
            nco_q = jnp.zeros_like(x)
            st = pll_state
            st_out = pll_state
            for k in range(T):
                def run(s):
                    return pll(x, s, **params)

                def skip(s):
                    return jnp.zeros_like(x), jnp.zeros_like(x), s

                ni, nq, st_k = lax.cond(t_id == k, run, skip, st)
                nco_i = jnp.where(t_id == k, ni, nco_i)
                nco_q = jnp.where(t_id == k, nq, nco_q)
                st_out = jax.tree.map(
                    lambda new, old: jnp.where(t_id == k, new, old), st_k, st_out)
                if k + 1 < T:
                    st = jax.tree.map(send_right, st_k)
            final = jax.tree.map(from_last, st_out)
            return nco_i, nco_q, final

        # ---- ingest + front end ----
        pairs = raw_u8.reshape(*raw_u8.shape[:-1], -1, 2)
        iq = (jnp.swapaxes(pairs, -1, -2).astype(dtype)
              - 128.0) * (1.0 / 128.0)
        zi_fe = jnp.stack([state.frontend.zi_i, state.frontend.zi_q],
                          axis=-2)
        iq_ds, zi_fe_new = halo_fir(fir_decimate, iq, rf_h, zi_fe,
                                    cfg.rf.decim)
        if_i, if_q = iq_ds[..., 0, :], iq_ds[..., 1, :]
        zi_i_new = zi_fe_new[..., 0, :]
        zi_q_new = zi_fe_new[..., 1, :]

        prev_local = jnp.stack([if_i[..., -1], if_q[..., -1]], axis=-1)
        prev_recv = send_right(prev_local)
        prev_i = first_or(state.frontend.prev_i, prev_recv[..., 0])
        prev_q = first_or(state.frontend.prev_q, prev_recv[..., 1])
        fm, (pi, pq) = fm_discriminator(if_i, if_q, (prev_i, prev_q))
        fe_state = FrontendState(
            zi_i=zi_i_new, zi_q=zi_q_new,
            prev_i=from_last(pi), prev_q=from_last(pq))

        # ---- mono ----
        fm_u_tail = _upsampled_tail_of(fm, a_taps - 1, up)
        mono, mono_zi = halo_fir(fir_resample, fm, audio_h,
                                 state.audio.mono_zi, up, down,
                                 tail=fm_u_tail)

        # ---- stereo ----
        pilot, pilot_zi = halo_fir(fir_block, fm, pilot_h,
                                   state.audio.pilot_zi)
        pcfg = cfg.stereo.pll
        nco, _, pll_st = pll_chain(
            pilot, state.audio.pll,
            freq=pcfg.freq, fs=cfg.rf.if_fs,
            nco_scale=pcfg.nco_scale, phase_adjust=pcfg.phase_adjust,
            norm_bandwidth=pcfg.norm_bandwidth, loop_div=pll_loop_div)
        chan, chan_zi = halo_fir(fir_block, fm, chan_h, state.audio.chan_zi)
        mixed = 2.0 * chan * nco
        st_u_tail = _upsampled_tail_of(mixed, a_taps - 1, up)
        stereo, stereo_zi = halo_fir(fir_resample, mixed, audio_h,
                                     state.audio.stereo_zi, up, down,
                                     tail=st_u_tail)
        if blend_range is not None:
            # pilot RMS over the FULL block (the serial receiver's
            # stateless per-block metric, pipeline/audio.py): psum the
            # per-shard pilot-power partial sums over t — the blend
            # factor replicates, each shard scales its own stereo chunk.
            # Not bitwise vs serial (different reduction grouping of the
            # same mean); agrees to f32 reduction noise (~1e-7 relative).
            lo, hi = blend_range
            p_ss = lax.psum(jnp.sum(pilot * pilot, axis=-1, keepdims=True),
                            TIME_AXIS)
            p_rms = jnp.sqrt(p_ss * (1.0 / cfg.if_len))
            blend = jnp.clip((p_rms - lo) * (1.0 / (hi - lo)), 0.0, 1.0)
            stereo = stereo * blend
        left = 0.5 * (mono + stereo)
        right = 0.5 * (mono - stereo)
        de_carry = None
        if deemphasis is not None:
            # De-emphasis IIR at the (tiny) 48 kS/s rate: gather the audio
            # chunks, run the identical serial scan replicated on every time
            # shard — bit-exact with the serial receiver by construction —
            # and slice the local chunk back out.
            lr = jnp.stack([left, right], axis=-2)
            chunk_a = lr.shape[-1]
            lr_full = lax.all_gather(lr, TIME_AXIS, axis=lr.ndim - 1,
                                     tiled=True)
            lr_de, de_carry = deemphasize(lr_full, state.audio.deemph,
                                          fs=cfg.audio_fs, tau=deemphasis)
            lr_loc = lax.dynamic_slice_in_dim(lr_de, t_id * chunk_a, chunk_a,
                                              axis=lr_de.ndim - 1)
            left, right = lr_loc[..., 0, :], lr_loc[..., 1, :]
        au_state = AudioState(mono_zi=mono_zi, pilot_zi=pilot_zi,
                              chan_zi=chan_zi, stereo_zi=stereo_zi,
                              pll=pll_st, deemph=de_carry)

        rds_state = None
        frame_state = None
        rds_out = None
        if enable_rds:
            extract, extract_zi = halo_fir(fir_block, fm, extract_h,
                                           state.rds.extract_zi)
            sq = extract * extract
            pre_pll, squared_zi = halo_fir(fir_block, sq, squared_h,
                                           state.rds.squared_zi)
            rp = cfg.rds.pll
            nco_i, nco_q, rds_pll = pll_chain(
                pre_pll, state.rds.pll,
                freq=rp.freq, fs=cfg.rf.if_fs,
                nco_scale=rp.nco_scale, phase_adjust=rp.phase_adjust,
                norm_bandwidth=rp.norm_bandwidth, loop_div=pll_loop_div)
            # I/Q mixers + composed resampler, as the serial receiver
            # (pipeline/rds.py); the halo is the left neighbor's
            # upsampled-domain tail
            mixed_rds = 2.0 * extract[..., None, :] * jnp.stack(
                [nco_i, nco_q], axis=-2)
            mix_u_tail = _upsampled_tail_of(mixed_rds, comb_taps - 1,
                                            cfg.rds.up)
            resamp, resamp_zi = halo_fir(fir_resample, mixed_rds, comb_h,
                                         state.rds.resamp_zi, cfg.rds.up,
                                         cfg.rds.down, tail=mix_u_tail)
            rrc, rrc_zi = halo_fir(fir_block, resamp, rrc_h,
                                   state.rds.rrc_zi)
            rds_state = RDSState(
                extract_zi=extract_zi, squared_zi=squared_zi, pll=rds_pll,
                resamp_zi=resamp_zi, rrc_zi=rrc_zi)

            if enable_frame:
                # gather the tiny 57 kS/s stream; bit layer runs replicated
                rrc_full = lax.all_gather(rrc, TIME_AXIS, axis=rrc.ndim - 1,
                                          tiled=True)
                rds_out, frame_state = frame_fn(
                    state.frame, rrc_full[..., 0, :], rrc_full[..., 1, :])
            else:
                rds_out = (rrc[..., 0, :], rrc[..., 1, :])

        new_state = ReceiverState(frontend=fe_state, audio=au_state,
                                  rds=rds_state, frame=frame_state)
        outputs = ReceiverOutputs(left=left, right=right, mono=mono,
                                  rds=rds_out)
        return new_state, outputs

    # ---- shardings ----
    def ch_spec(x):
        return P(CHANNEL_AXIS, *([None] * (x.ndim - 1)))

    state_proto = jax.eval_shape(serial_init)
    state_specs = jax.tree.map(ch_spec, state_proto)
    raw_spec = P(CHANNEL_AXIS, TIME_AXIS)
    audio_spec = P(CHANNEL_AXIS, TIME_AXIS)

    state_in_specs = state_specs

    # Output pytree structure (and leaf ndims) match the serial step; shapes
    # inside shards differ but only specs matter here.
    raw_proto = jax.ShapeDtypeStruct((n_channels, cfg.block_size), jnp.uint8)
    _, out_proto = jax.eval_shape(serial_step, state_proto, raw_proto)
    if enable_rds and enable_frame:
        rds_sp = jax.tree.map(ch_spec, out_proto.rds)   # replicated over t
    elif enable_rds:
        rds_sp = jax.tree.map(lambda x: P(CHANNEL_AXIS, TIME_AXIS),
                              out_proto.rds)            # chunked rrc streams
    else:
        rds_sp = None
    out_specs = (
        state_in_specs,
        ReceiverOutputs(left=audio_spec, right=audio_spec, mono=audio_spec,
                        rds=rds_sp),
    )

    sharded = jax.shard_map(shard_body, mesh=mesh,
                            in_specs=(state_in_specs, raw_spec),
                            out_specs=out_specs, check_vma=False)
    step_jit = jax.jit(sharded, donate_argnums=0)

    def init_fn():
        state = serial_init()
        def place(x):
            if x is None:
                return None
            return jax.device_put(
                jnp.array(x, copy=True), NamedSharding(mesh, ch_spec(x)))
        return jax.tree.map(place, state)

    def step_fn(state, raw_u8):
        raw_u8 = jax.device_put(raw_u8, NamedSharding(mesh, raw_spec))
        return step_jit(state, raw_u8)

    return init_fn, step_fn
