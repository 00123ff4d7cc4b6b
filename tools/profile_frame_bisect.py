"""Bisect the frame layer's cost: time progressively-truncated variants.

Diagnostic only — mirrors pipeline/frame.py stage structure with early
returns so each stage's marginal cost is visible.  Run on the GPU:
    python tools/profile_frame_bisect.py [C]
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rtsdr_tpu.pipeline.frame as F  # noqa: E402
from rtsdr_tpu.config import MODE0  # noqa: E402


def make_truncated(cfg, upto: str):
    """A frame-like fn computing stages up to `upto`, returning a live sum
    so nothing is dead-code-eliminated, plus a state passthrough."""
    i32 = jnp.int32
    r_len = cfg.rds_len
    sps = cfg.rds.sps
    s_max, b_max, e_max, w_max = F.frame_sizes(cfg)
    h_mat = jnp.asarray(F.H_MATRIX)
    synds = jnp.asarray(F.SYNDROMES)

    def fn(state, rrc_i, rrc_q):
        acc = []
        first24 = rrc_i[:sps]
        offset = jnp.where(state.first_block, jnp.argmax(first24).astype(i32),
                           state.offset)
        phases_i = rrc_i.reshape(s_max, sps)
        phases_q = rrc_q.reshape(s_max, sps)
        onehot = (jnp.arange(sps, dtype=i32) == offset % sps).astype(rrc_i.dtype)
        sym_i = jnp.sum(phases_i * onehot, axis=-1)
        sym_q = jnp.sum(phases_q * onehot, axis=-1)
        n_sym = ((r_len - offset + sps - 1) // sps).astype(i32)
        shift_sym = (offset >= sps).astype(i32)
        sym_i = jnp.where(shift_sym == 1, jnp.roll(sym_i, -1), sym_i)
        sym_pos_valid = jnp.arange(s_max, dtype=i32) < n_sym
        sym_i = jnp.where(sym_pos_valid, sym_i, 0.0)
        acc.append(jnp.sum(sym_i) + jnp.sum(sym_q))
        if upto == "symbols":
            return sum(acc), state

        pairs2 = sym_i.reshape(b_max, 2)
        even, odd = pairs2[:, 0], pairs2[:, 1]
        s4 = s_max // 4
        m_mask = jnp.arange(s4, dtype=i32) < n_sym // 4
        c0 = ((even[:s4] > 0) & (odd[:s4] > 0)) & m_mask
        count0 = jnp.sum(c0.astype(i32))
        start_pos = jnp.where(state.first_block,
                              jnp.where(count0 > 3, 1, 0), state.start_pos)
        j = jnp.arange(b_max, dtype=i32)
        odd_prev = jnp.concatenate([odd[:1], odd[:-1]])
        bits = jnp.where(start_pos == 0, (even > odd).astype(i32),
                         (odd_prev > even).astype(i32))
        prev = jnp.concatenate([state.prebit[None], bits[:-1]])
        diff_all = jnp.bitwise_xor(bits, prev)
        shift = jnp.where(state.first_block, 1, 0).astype(i32)
        diff = jnp.where(shift == 1,
                         jnp.concatenate([diff_all[1:], diff_all[:1]]),
                         diff_all)
        n_diff = (n_sym // 2).astype(i32) - shift
        acc.append(jnp.sum(diff))
        if upto == "bits":
            return sum(acc), state

        ext_first = jnp.concatenate([diff, jnp.zeros((F.CARRY_BITS,), i32)])
        ext_later = jnp.concatenate([state.carry, diff])
        ext = jnp.where(state.first_block, ext_first, ext_later)
        n_windows = state.carry_len + n_diff - 26
        windows27 = jnp.stack(
            [jax.lax.slice_in_dim(ext, k, k + w_max, axis=0)
             for k in range(F.CARRY_BITS)], axis=1)
        windows = windows27[:, :26]
        synd = jnp.mod(
            jax.lax.dot_general(
                windows.astype(jnp.float32), h_mat.astype(jnp.float32),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32), 2.0).astype(i32)
        match = jnp.all(synd[:, None, :] == synds[None, :, :], axis=-1)
        sid = jnp.where(jnp.any(match, axis=-1),
                        jnp.argmax(match, axis=-1).astype(i32) + 1, 0)
        acc.append(jnp.sum(sid))
        if upto == "syndrome":
            return sum(acc), state

        w_valid = jnp.arange(w_max, dtype=i32) < n_windows
        out = F.resolve_sync(sid, w_valid, state.base_pos,
                             state.last_position, state.bad_count,
                             resync=False)
        acc.append(jnp.sum(out[0]) + out[3])
        if upto == "sync":
            return sum(acc), state

        pow2 = jnp.asarray(2.0 ** np.arange(15, -1, -1), jnp.float32)
        info = (windows27[:, :16].astype(jnp.float32) @ pow2).astype(i32)
        row_hot = (jnp.arange(w_max, dtype=i32) == n_windows - 1
                   ).astype(jnp.float32)
        carry = jnp.einsum("w,wj->j", row_hot,
                           windows27.astype(jnp.float32)).astype(i32)
        acc.append(jnp.sum(info) + jnp.sum(carry))
        return sum(acc), state

    return fn


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    cfg = MODE0
    rng = np.random.default_rng(0)
    rrc = jnp.asarray(rng.standard_normal((C, cfg.rds_len)).astype(np.float32))
    st0 = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape).copy(),
        F.frame_init(cfg, jnp.float32))

    for upto in ("symbols", "bits", "syndrome", "sync", "full"):
        fn = jax.vmap(make_truncated(cfg, upto))
        step = jax.jit(lambda s, x: fn(s, x, x))

        def run(k):
            s = jax.tree.map(lambda x: jnp.array(x, copy=True), st0)
            jax.block_until_ready(s)
            x = rrc
            t0 = time.perf_counter()
            for _ in range(k):
                acc, s = step(s, x)
                x = x + acc[..., None] * 1e-20  # serialize steps
            float(jnp.sum(x[..., :1]))
            return time.perf_counter() - t0

        run(3)
        run(13)
        t1 = min(run(3) for _ in range(2))
        t2 = min(run(13) for _ in range(2))
        print(json.dumps({"upto": upto,
                          "ms": round((t2 - t1) / 10 * 1e3, 4)}), flush=True)


if __name__ == "__main__":
    main()
