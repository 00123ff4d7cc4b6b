"""PLL / NCO carrier recovery: a ``lax.scan`` recurrence, or its GPU kernel.

Faithful to the golden model ``fmPll`` (model/fmPll.py:4-49): first-order
loop with an atan2 phase detector, PI loop filter (Cp=2.666, Ci=3.555,
Kp=B*Cp, Ki=B^2*Ci), and an NCO emitting cos/sin(trigArg*ncoScale +
phaseAdjust).  The recurrence is inherently sequential per channel —
throughput comes from batching and sharding across channels, not from
parallelizing a single loop (SURVEY.md §7 "hard parts" #1).  On the GPU
the float32 loop runs as one Pallas kernel that keeps each lane's state
in registers (``ops/pll_kernel.py``); ``lax.scan`` is the reference.

Improvements over the reference, deliberate (SURVEY.md §7):

* The reference accumulates ``trigOffset`` and ``phaseEst`` without bound
  (model/fmPll.py:33,44), so float32 trig arguments lose precision within
  minutes of stream time.  We wrap both modulo 4*pi each step — exact for
  any half-integer ``nco_scale`` (cos((x mod 4pi)*s + p) == cos(x*s + p)
  for s in {0.5, 1, 2, ...}) — so float32 stays accurate indefinitely.
* Both NCO quadratures are carried in the state (the reference leaves
  ``ncoOutQ[0]`` uninitialized, model/fmPll.py:13,36-37).

Output alignment matches the model's consumers exactly: the model returns
``ncoOut`` of length N+1 whose element 0 is the *previous* block's last NCO
sample, and the mixers consume ``ncoOut[0:N]`` (model/fmMonoBlock.py:155,
model/fmRDSblock.py:173-175) — i.e. the NCO is applied with one sample of
delay.  ``pll`` returns that delayed-by-one view directly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.ops import paths


class PLLState(NamedTuple):
    """Block-continuity state (reference pll_state_type, src/helper.h:17-19)."""

    integrator: jax.Array
    phase_est: jax.Array   # wrapped mod 4*pi
    fb_i: jax.Array
    fb_q: jax.Array
    nco_i: jax.Array       # last NCO cos sample (model recovery_state[4])
    nco_q: jax.Array       # last NCO sin sample
    theta: jax.Array       # 2*pi*(freq/fs)*trigOffset, wrapped mod 4*pi


_FOUR_PI = 4.0 * math.pi


def pll_init(batch_shape: tuple = (), dtype=jnp.float32) -> PLLState:
    """Initial state matching the model's [0, 0, 1, 0, 1, 0] convention
    (model/fmMonoBlock.py:76) plus nco_q=0."""
    z = jnp.zeros(batch_shape, dtype=dtype)
    o = jnp.ones(batch_shape, dtype=dtype)
    return PLLState(integrator=z, phase_est=z, fb_i=o, fb_q=z,
                    nco_i=o, nco_q=z, theta=z)


def _loop_constants(freq, fs, nco_scale, phase_adjust, norm_bandwidth,
                    loop_div):
    """Float64 host values of the per-lane loop constants (kp, ki, dtheta,
    nco_scale, phase_adjust), each broadcastable to the batch shape.

    ``loop_div`` scales the gains so the loop bandwidth in Hz is unchanged
    at the decimated update rate."""
    cp, ci = 2.666, 3.555
    nb64 = np.asarray(norm_bandwidth, np.float64) * loop_div
    return (nb64 * cp, nb64 * nb64 * ci,
            2.0 * math.pi * np.asarray(freq, np.float64) / fs,
            np.asarray(nco_scale, np.float64),
            np.asarray(phase_adjust, np.float64))


def pll(
    x: jax.Array,
    state: PLLState,
    *,
    freq: float,
    fs: float,
    nco_scale: float = 1.0,
    phase_adjust: float = 0.0,
    norm_bandwidth: float = 0.01,
    unroll: int = 2,
    impl: str = "auto",
    delay_output: bool = True,
    loop_div: int = 1,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, PLLState]:
    """Run the PLL over one block.

    Args:
      x: (..., N) real input (band-passed pilot / squared carrier); or a
        TUPLE of equal-shape arrays, treated exactly as
        ``jnp.stack(x, axis=0)`` (the receiver feeds the stereo-pilot +
        RDS-carrier pair this way).
      state: PLLState with fields shaped (...,).
      impl: 'scan' (``lax.scan``, any platform and dtype), 'kernel' (the
        GPU Pallas kernel, ``ops/pll_kernel.py``) or 'auto' (default:
        ``ops.paths.choose('pll', dtype)``).
      interpret: run the kernel in Pallas interpret mode (tests only).
      delay_output: True (default) reproduces the golden model's
        ``ncoOut[0:N]`` mixer view.  Because ``ncoOut`` entries are
        one-indexed (ncoOut[k+1] holds the NCO at sample k), this view is
        the *time-aligned* one.  False shifts the NCO one sample early
        (diagnostic only).
      loop_div: run the loop-filter recurrence only every ``loop_div``-th
        sample (1 = golden parity).  The NCO / feedback angles still
        advance at full rate, so the output is a full-rate carrier; the
        detector samples the error process ``loop_div`` x more sparsely
        and the PI gains are scaled (norm_bandwidth x loop_div at the
        decimated update rate) so the loop's bandwidth in Hz is
        unchanged.  Lock/tracking behavior is preserved within the loop's
        own noise (tests assert stereo separation and RDS sync parity at
        div<=4).  N must be divisible by loop_div.

    Returns:
      nco_i, nco_q: (..., N) NCO outputs *delayed by one sample* (the
        model's ``ncoOut[0:N]`` view — element 0 is the previous block's
        last NCO sample).
      new_state.
    """
    parts = list(x) if isinstance(x, (tuple, list)) else [x]
    if any(p.shape != parts[0].shape or p.dtype != parts[0].dtype
           for p in parts[1:]):
        raise ValueError(
            "pll tuple input requires equal shapes/dtypes, got "
            f"{[(p.shape, p.dtype) for p in parts]}")
    dtype = parts[0].dtype
    if impl == "auto":
        impl = paths.choose("pll", dtype)
    if impl not in ("scan", "kernel"):
        raise ValueError(f"unknown pll impl {impl!r}")
    if loop_div < 1 or parts[0].shape[-1] % loop_div:
        raise ValueError(f"block length {parts[0].shape[-1]} is not a "
                         f"multiple of loop_div {loop_div}")
    consts = _loop_constants(freq, fs, nco_scale, phase_adjust,
                             norm_bandwidth, loop_div)
    if impl == "kernel":
        return _pll_kernel(parts, state, consts, delay_output, loop_div,
                           interpret)
    x = parts[0] if len(parts) == 1 else jnp.stack(parts, axis=0)
    # freq / norm_bandwidth / nco_scale / phase_adjust may be arrays
    # broadcastable to the batch shape (fusing differently-configured loop
    # instances into one call — e.g. the stereo pilot and RDS carrier
    # loops); per-lane numerics are identical to separate calls because the
    # derived constants are computed in float64 host-side, then cast.
    kp, ki, dtheta, scale, adjust = (jnp.asarray(v).astype(dtype)
                                     for v in consts)
    four_pi = jnp.asarray(_FOUR_PI, dtype)

    # time-major for scan: (N, ...)
    xs = jnp.moveaxis(x, -1, 0)

    def update(carry, xk):
        """One loop-filter update from detector sample xk (pre-update
        feedback angles), followed by a theta advance."""
        integ, phase, fb_i, fb_q, theta = carry
        error_i = xk * fb_i
        error_q = xk * (-fb_q)
        error_d = jnp.arctan2(error_q, error_i)
        integ = integ + ki * error_d
        phase = jnp.mod(phase + kp * error_d + integ, four_pi)
        return integ, phase, theta

    def emit(phase, theta, dth):
        theta = jnp.mod(theta + dth, four_pi)
        arg = theta + phase
        nco_arg = arg * scale + adjust
        return theta, arg, jnp.cos(nco_arg), jnp.sin(nco_arg)

    if loop_div == 1:
        def step(carry, xk):
            integ, phase, theta = update(carry, xk)
            theta, arg, nco_i, nco_q = emit(phase, theta, dtheta)
            return ((integ, phase, jnp.cos(arg), jnp.sin(arg), theta),
                    (nco_i, nco_q))
        scan_xs = xs
    else:
        # grouped scan: one recurrence per group of loop_div samples, the
        # NCO/theta advancing per sample (full-rate carrier out)
        def step(carry, xg):
            integ, phase, theta = update(carry, xg[0])
            outs_i, outs_q = [], []
            for j in range(loop_div):
                theta, arg, nco_i, nco_q = emit(phase, theta, dtheta)
                outs_i.append(nco_i)
                outs_q.append(nco_q)
            return ((integ, phase, jnp.cos(arg), jnp.sin(arg), theta),
                    (jnp.stack(outs_i), jnp.stack(outs_q)))
        scan_xs = xs.reshape(xs.shape[0] // loop_div, loop_div,
                             *xs.shape[1:])

    carry0 = (state.integrator, state.phase_est, state.fb_i, state.fb_q,
              state.theta)
    (integ, phase, fb_i, fb_q, theta), (nco_i_seq, nco_q_seq) = jax.lax.scan(
        step, carry0, scan_xs, unroll=unroll)
    if loop_div > 1:
        nco_i_seq = nco_i_seq.reshape(-1, *nco_i_seq.shape[2:])
        nco_q_seq = nco_q_seq.reshape(-1, *nco_q_seq.shape[2:])

    # (N, ...) -> (..., N)
    nco_i_new = jnp.moveaxis(nco_i_seq, 0, -1)
    nco_q_new = jnp.moveaxis(nco_q_seq, 0, -1)

    if delay_output:
        # Delayed-by-one view: prepend previous block's last NCO sample.
        nco_i = jnp.concatenate([state.nco_i[..., None], nco_i_new[..., :-1]],
                                axis=-1)
        nco_q = jnp.concatenate([state.nco_q[..., None], nco_q_new[..., :-1]],
                                axis=-1)
    else:
        nco_i, nco_q = nco_i_new, nco_q_new

    new_state = PLLState(
        integrator=integ, phase_est=phase, fb_i=fb_i, fb_q=fb_q,
        nco_i=nco_i_new[..., -1], nco_q=nco_q_new[..., -1], theta=theta)
    return nco_i, nco_q, new_state


def _pll_kernel(parts, state, consts, delay_output, loop_div, interpret):
    """``pll`` through the GPU kernel (``ops/pll_kernel.py``): the kernel
    runs the recurrence over the flattened lanes; the NCO synthesis and
    the delayed view are the scan's own expressions, in XLA."""
    from rtsdr_tpu.ops.pll_kernel import lane_rows, pll_args

    n = parts[0].shape[-1]
    batch = ((len(parts),) if len(parts) > 1 else ()) + parts[0].shape[:-1]
    c = math.prod(batch)
    dtype = parts[0].dtype
    x = jnp.concatenate([p.reshape(-1, n) for p in parts], axis=0)
    flat = lambda v: jnp.broadcast_to(v, batch).reshape(c)
    st = jnp.stack([flat(state.integrator), flat(state.phase_est),
                    flat(state.theta),
                    flat(jnp.arctan2(state.fb_q, state.fb_i))]).astype(dtype)
    kp, ki, dtheta, scale, adjust = consts
    args, so = pll_args(x, lane_rows((kp, ki, dtheta), batch, dtype), st,
                        loop_div=loop_div, interpret=interpret)
    args = args.reshape(*batch, n)
    scale = jnp.asarray(np.broadcast_to(scale, batch), dtype)[..., None]
    adjust = jnp.asarray(np.broadcast_to(adjust, batch), dtype)[..., None]
    nco_arg = args * scale + adjust
    nco_i_new, nco_q_new = jnp.cos(nco_arg), jnp.sin(nco_arg)
    if delay_output:
        nco_i = jnp.concatenate([jnp.broadcast_to(state.nco_i, batch)[..., None],
                                 nco_i_new[..., :-1]], axis=-1)
        nco_q = jnp.concatenate([jnp.broadcast_to(state.nco_q, batch)[..., None],
                                 nco_q_new[..., :-1]], axis=-1)
    else:
        nco_i, nco_q = nco_i_new, nco_q_new
    unflat = lambda v: v.reshape(batch)
    arg_end = unflat(so[3])
    new_state = PLLState(
        integrator=unflat(so[0]), phase_est=unflat(so[1]),
        fb_i=jnp.cos(arg_end), fb_q=jnp.sin(arg_end),
        nco_i=nco_i_new[..., -1], nco_q=nco_q_new[..., -1],
        theta=unflat(so[2]))
    return nco_i, nco_q, new_state


def pll_extrapolate_by(
    state: PLLState,
    theta_advance,
    n_steps,
    *,
    nco_scale: float = 1.0,
    phase_adjust: float = 0.0,
) -> PLLState:
    """Advance a PLL state with no input, assuming lock, by a precomputed
    ramp advance.

    In lock the detector error is ~0, so per step the loop advances
    ``theta`` by the NCO ramp ``2*pi*freq/fs`` and ``phase_est`` by the
    integrator (the steady-state slope of ``phase = phase + kp*e + integ``
    with e ~ 0; see the scan body above).  The feedback and NCO samples are
    recomputed from the extrapolated angles exactly as the loop would.

    ``theta_advance`` is ``(n_steps * dtheta) mod 4*pi`` — compute it
    host-side in float64 so extrapolation adds no trig-argument drift.
    Both ``theta_advance`` and ``n_steps`` may be arrays broadcastable to
    the state's batch shape (time-sharded receivers extrapolate each shard
    by its own offset in one call).
    """
    dtype = state.phase_est.dtype
    four_pi = jnp.asarray(_FOUR_PI, dtype)
    theta = jnp.mod(state.theta + jnp.asarray(theta_advance, dtype), four_pi)
    phase = jnp.mod(state.phase_est
                    + jnp.asarray(n_steps, dtype) * state.integrator,
                    four_pi)
    arg = theta + phase
    scale = jnp.asarray(np.asarray(nco_scale, np.float64)).astype(dtype)
    adjust = jnp.asarray(np.asarray(phase_adjust, np.float64)).astype(dtype)
    nco_arg = arg * scale + adjust
    return PLLState(integrator=state.integrator, phase_est=phase,
                    fb_i=jnp.cos(arg), fb_q=jnp.sin(arg),
                    nco_i=jnp.cos(nco_arg), nco_q=jnp.sin(nco_arg),
                    theta=theta)


def pll_extrapolate(
    state: PLLState,
    n_steps: int,
    *,
    freq: float,
    fs: float,
    nco_scale: float = 1.0,
    phase_adjust: float = 0.0,
) -> PLLState:
    """Advance a PLL state ``n_steps`` samples with no input, assuming lock.

    This is the stale-handoff primitive for time-sharded latency scaling
    (parallel/timeshard.py ``pll_handoff='stale'|'iterate'``): each time
    shard seeds its chunk from the exact end-of-previous-block carry,
    extrapolated across its own start offset — removing the sequential
    shard-to-shard pipeline (the Amdahl term of time sharding) at the cost of a lock-transient approximation instead
    of bit-exact parity.  See ``pll_extrapolate_by`` for the math.
    """
    dth = np.mod(2.0 * np.pi * np.float64(freq) / np.float64(fs)
                 * np.float64(n_steps), 2.0 * _FOUR_PI) % _FOUR_PI
    return pll_extrapolate_by(state, dth, float(n_steps),
                              nco_scale=nco_scale,
                              phase_adjust=phase_adjust)
