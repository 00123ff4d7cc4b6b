"""Full receiver: one jitted block-step over the whole signal-flow graph.

The reference runs four pthreads with bounded queues (src/fm_radio.cpp:
767-792); here the complete graph — front end, mono+stereo audio, RDS DSP,
RDS bit layer — is ONE pure function

    step(state, raw_u8) -> (state, outputs)

traced and compiled once by XLA.  The fan-out of the demodulated signal to
the audio and RDS branches (the reference's dual queue push,
src/fm_radio.cpp:124-125) is just two uses of one value; the ring buffer
becomes the donated state pytree (zero-copy in-place update on device).

uint8 -> float conversion runs on device: the host transfers 1 byte per
sample and the device does (x - 128)/128 (the reference converts on the
host, src/iofunc.cpp:67).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.ops import coeffs
from rtsdr_tpu.ops.fir import fir_block, fir_block_bank
from rtsdr_tpu.ops.pll import pll
from rtsdr_tpu.pipeline.audio import AudioState, audio_init, make_audio
from rtsdr_tpu.pipeline.frame import (
    FrameOutputs,
    FrameState,
    frame_init,
    make_frame,
)
from rtsdr_tpu.pipeline.frontend import (
    FrontendState,
    frontend_init,
    make_frontend,
)
from rtsdr_tpu.pipeline.rds import RDSState, make_rds, rds_init


class ReceiverState(NamedTuple):
    frontend: FrontendState
    audio: AudioState
    rds: RDSState | None
    frame: FrameState | None


class ReceiverOutputs(NamedTuple):
    left: jax.Array    # (..., audio_len) 48 kS/s
    right: jax.Array
    mono: jax.Array
    rds: Any           # FrameOutputs | (rrc_i, rrc_q) | None


def make_receiver(
    cfg: ReceiverConfig,
    batch_shape: tuple = (),
    dtype=jnp.float32,
    *,
    enable_rds: bool | None = None,
    enable_frame: bool = True,
    enable_stereo: bool = True,
    offset_mode: str = "hold",
    use_abs_clock: bool = False,
    resync: bool = False,
    error_correct: bool = False,
    deemphasis: float | None = None,
    frontend_impl: str = "u8",
    pll_loop_div: int = 1,
    stereo_blend: bool | tuple = False,
    derotate: bool = False,
):
    """Build ``(init_fn, step_fn)`` for the full receiver.

    ``batch_shape`` prepends channel dimensions: every state leaf and every
    input/output gains those leading dims, and all DSP runs batched (the
    multi-station use case).

    ``step_fn(state, raw_u8)``: raw_u8 is (..., block_size) interleaved
    uint8 IQ — or, with ``frontend_impl='iq'``/``'if'``, float stacked
    I/Q (the wideband channelizer's per-channel output;
    pipeline/frontend.py).

    ``pll_loop_div``: run the PLL loop-filter recurrence every N-th sample
    with bandwidth-preserving gains (NCO still full-rate) — ~N x faster
    PLL stage, same lock behavior, not bit-identical to the golden model
    (see ops/pll.py).  1 (default) = golden parity.
    """
    if enable_rds is None:
        enable_rds = cfg.rds is not None
    if enable_rds and cfg.rds is None:
        raise ValueError(f"mode {cfg.mode} has no RDS path")

    frontend = make_frontend(cfg, dtype, impl=frontend_impl)
    audio = make_audio(cfg, enable_stereo=enable_stereo,
                       deemphasis=deemphasis, pll_loop_div=pll_loop_div,
                       stereo_blend=stereo_blend)
    rds_fn = (make_rds(cfg, pll_loop_div=pll_loop_div)
              if enable_rds else None)

    # With both stereo and RDS on, three IF-rate band-passes (pilot,
    # stereo channel, RDS extraction) filter the SAME demodulated signal
    # with equal tap counts: fuse them into one stacked banded matmul that
    # reads the input windows once (ops/fir.py fir_block_multi).
    # The two PLL instances (stereo pilot x2, RDS carrier x0.5) likewise
    # fuse into ONE loop call with per-lane constants (ops/pll.py) — the
    # sequential recurrence is the chain's latency floor, so halving the
    # number of loop passes matters more than any FLOP count.
    if_bank_h = None
    fuse_pll = False
    squared_h = None
    if enable_stereo and enable_rds and cfg.stereo.taps == cfg.rds.taps:
        import numpy as _np

        if_fs = cfg.rf.if_fs
        if_bank_h = [
            coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                 cfg.stereo.pilot_hi, cfg.stereo.taps),
            coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                 cfg.stereo.chan_hi, cfg.stereo.taps),
            coeffs.bandpass_taps(if_fs, cfg.rds.extract_lo,
                                 cfg.rds.extract_hi, cfg.rds.taps),
        ]
        fuse_pll = cfg.stereo.nco_delay  # both loops use the delayed view
        if fuse_pll:
            squared_h = coeffs.bandpass_taps(if_fs, cfg.rds.squared_lo,
                                             cfg.rds.squared_hi, cfg.rds.taps)
            sp, rp = cfg.stereo.pll, cfg.rds.pll
            # config axis leads (shape (2, 1, ..., 1)): per-lane loop
            # constants broadcast over the channel batch
            _b1 = (2,) + (1,) * len(batch_shape)
            pll_freqs = _np.array([sp.freq, rp.freq]).reshape(_b1)
            pll_bws = _np.array(
                [sp.norm_bandwidth, rp.norm_bandwidth]).reshape(_b1)
            pll_scales = _np.array([sp.nco_scale, rp.nco_scale]).reshape(_b1)
            pll_adjusts = _np.array(
                [sp.phase_adjust, rp.phase_adjust]).reshape(_b1)
    frame_fn = None
    if enable_rds and enable_frame:
        frame_fn = make_frame(cfg, offset_mode=offset_mode,
                              use_abs_clock=use_abs_clock, resync=resync,
                              error_correct=error_correct,
                              derotate=derotate)
        for _ in batch_shape:
            frame_fn = jax.vmap(frame_fn)

    def init_fn() -> ReceiverState:
        rds_state = rds_init(cfg, batch_shape, dtype) if enable_rds else None
        frame_state = None
        if frame_fn is not None:
            fs = frame_init(cfg, dtype)
            if batch_shape:
                fs = jax.tree.map(
                    lambda x: jnp.broadcast_to(x, batch_shape + x.shape), fs)
            frame_state = fs
        return ReceiverState(
            frontend=frontend_init(cfg, batch_shape, dtype),
            audio=audio_init(cfg, batch_shape, dtype,
                             enable_stereo=enable_stereo,
                             deemphasis=deemphasis),
            rds=rds_state,
            frame=frame_state,
        )

    def step_fn(state: ReceiverState, raw_u8: jax.Array):
        fm, fe_state = frontend(state.frontend, raw_u8)

        pilot = chan = extract = None
        audio_nco = rds_nco = None
        if if_bank_h is not None:
            (pilot, chan, extract), _ = fir_block_bank(
                fm, if_bank_h, state.audio.pilot_zi)
            if fuse_pll:
                pre_pll, squared_zi = fir_block(extract * extract, squared_h,
                                                state.rds.squared_zi)
                # tuple input: the pair is read as one lane batch
                # (ops/pll.py) without a separate stack in the caller
                pair = (pilot, pre_pll)
                st2 = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=0),
                                   state.audio.pll, state.rds.pll)
                nco_i2, nco_q2, st2 = pll(
                    pair, st2, freq=pll_freqs, fs=cfg.rf.if_fs,
                    nco_scale=pll_scales, phase_adjust=pll_adjusts,
                    norm_bandwidth=pll_bws, loop_div=pll_loop_div)
                audio_nco = (nco_i2[0], jax.tree.map(lambda v: v[0], st2))
                rds_nco = (nco_i2[1], nco_q2[1],
                           jax.tree.map(lambda v: v[1], st2),
                           squared_zi)
        (left, right, mono), au_state = audio(state.audio, fm,
                                              pilot=pilot, chan=chan,
                                              nco_pre=audio_nco)

        rds_state = None
        frame_state = None
        rds_out = None
        if rds_fn is not None:
            (rrc_i, rrc_q), rds_state = rds_fn(state.rds, fm, extract=extract,
                                               nco_pre=rds_nco)
            if frame_fn is not None:
                rds_out, frame_state = frame_fn(state.frame, rrc_i, rrc_q)
            else:
                rds_out = (rrc_i, rrc_q)

        new_state = ReceiverState(frontend=fe_state, audio=au_state,
                                  rds=rds_state, frame=frame_state)
        return new_state, ReceiverOutputs(left=left, right=right, mono=mono,
                                          rds=rds_out)

    return init_fn, step_fn


class Receiver:
    """Convenience wrapper: jitted step with donated state."""

    def __init__(self, cfg: ReceiverConfig, batch_shape: tuple = (),
                 dtype=jnp.float32, jit: bool = True, **kwargs):
        self.cfg = cfg
        self.batch_shape = batch_shape
        self.init_fn, step = make_receiver(cfg, batch_shape, dtype, **kwargs)
        self.step = jax.jit(step, donate_argnums=0) if jit else step

    def init(self) -> ReceiverState:
        state = self.init_fn()
        # Identical zero-leaves can share one device buffer, which breaks
        # donation ("donate the same buffer twice"); force distinct buffers.
        return jax.tree.map(lambda x: jnp.array(x, copy=True), state)
