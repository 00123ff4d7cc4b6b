"""Pallas (Triton) kernel for the PLL recurrence on the GPU.

The PLL is the chain's one sequential recurrence: every IF sample of a
block depends on the previous one.  ``lax.scan`` compiles to a while loop
that launches a few small kernels per sample.  Here each lane (one
station's loop) is one GPU thread that keeps its loop state in registers
for the entire block; a program is one warp of ``_BLOCK`` lanes, so the
2x1024 lanes of a fleet step spread over 64 SMs.  Lanes are read
channel-major, (c, n) as the receiver holds them: each thread walks its
own row, ``_TILE`` samples per loop iteration issued together so their
load latency overlaps.

The kernel runs only the recurrence and writes the NCO argument
``theta + phase`` per sample; the NCO ``cos/sin(arg * scale + adjust)``
and the delayed-by-one view are data-parallel and run in XLA around it
(``ops.pll._pll_kernel``).  With one warp per SM nothing else hides the
loop's latency, so every instruction kept off the chain counts.

The math is that of ``ops.pll.pll`` with one identity (NUMERICS.md): the
detector ``atan2(-x sin a, x cos a)`` is ``wrap(-a)`` for x > 0 and
``wrap(pi - a)`` for x < 0 (0 for x == 0), wrapped to (-pi, pi] as atan2
is: a select and a wrap, no transcendental in the loop.

The kernel compiles only for the GPU.  Tests run it with
``interpret=True``; nothing here switches to interpret mode by itself.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLOCK = 32     # lanes per program: one warp, one lane per thread
_TILE = 8       # samples whose input loads are issued together
_TWO_PI = 2.0 * math.pi
_FOUR_PI = 4.0 * math.pi


def _kernel(x_ref, par_ref, st_ref, arg_ref, so_ref, *, n: int, c: int,
            loop_div: int):
    """One program = ``_BLOCK`` lanes over the whole block of n samples.

    x_ref/arg_ref: (c, n).  par_ref rows: kp, ki, dtheta.  st_ref/so_ref
    rows: integrator, phase, theta, feedback argument.
    """
    lanes = pl.program_id(0) * _BLOCK + jnp.arange(_BLOCK)
    mask = lanes < c

    def row(ref, i):
        return plgpu.load(ref.at[i, lanes], mask=mask, other=0.0)

    kp, ki, dth = (row(par_ref, i) for i in range(3))

    def step(r, x, carry):
        integ, phase, theta, arg = carry
        if r % loop_div == 0:
            s = jnp.where(x > 0, 1.0, jnp.where(x < 0, -1.0, 0.0))
            z = (0.5 * math.pi) * (1.0 - s) - arg
            e = s * s * (z - _TWO_PI * jnp.ceil(z * (1.0 / _TWO_PI) - 0.5))
            integ = integ + ki * e
            phase = jnp.mod(phase + kp * e + integ, _FOUR_PI)
        theta = jnp.mod(theta + dth, _FOUR_PI)
        return integ, phase, theta, theta + phase

    def run(t0, count, carry):
        xs = [plgpu.load(x_ref.at[lanes, t0 + r], mask=mask, other=0.0)
              for r in range(count)]
        for r in range(count):
            carry = step(r, xs[r], carry)
            plgpu.store(arg_ref.at[lanes, t0 + r], carry[3], mask=mask)
        return carry

    carry = tuple(row(st_ref, i) for i in range(4))
    n_tiles = n // _TILE
    carry = jax.lax.fori_loop(
        0, n_tiles, lambda i, cr: run(i * _TILE, _TILE, cr), carry)
    if n % _TILE:
        carry = run(n_tiles * _TILE, n % _TILE, carry)
    for i, v in enumerate(carry):
        plgpu.store(so_ref.at[i, lanes], v, mask=mask)


@partial(jax.jit, static_argnames=("loop_div", "interpret"))
def pll_args(x, params, state, *, loop_div: int, interpret: bool = False):
    """Run the loop over lanes.

    x: (c, n) input; params: (3, c) kp, ki, dtheta; state: (4, c)
    integrator, phase, theta, feedback argument.  Returns the (c, n) NCO
    argument ``theta + phase`` after each sample and the (4, c) end
    state.  Any lane count works: the last program masks its tail.
    ``loop_div`` must divide ``_TILE`` and ``n``.
    """
    c, n = x.shape
    if _TILE % loop_div or n % loop_div:
        raise ValueError(f"loop_div {loop_div} must divide {_TILE} and the "
                         f"block length {n}")
    return pl.pallas_call(
        partial(_kernel, n=n, c=c, loop_div=loop_div),
        grid=(pl.cdiv(c, _BLOCK),),
        out_shape=(jax.ShapeDtypeStruct((c, n), x.dtype),
                   jax.ShapeDtypeStruct((4, c), x.dtype)),
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="pll_loop",
    )(x, params, state)


def lane_rows(values, batch_shape, dtype) -> jax.Array:
    """(len(values), c) rows of host values broadcast over the lanes."""
    c = math.prod(batch_shape)
    return jnp.asarray(np.stack(
        [np.broadcast_to(np.asarray(v, np.float64), batch_shape).reshape(c)
         for v in values]), dtype)
