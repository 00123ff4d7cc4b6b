"""Micro-benchmark the RDS frame layer alone at a given channel count.

Slope-times vmap(make_frame) on synthetic RRC blocks (state threaded so
steps serialize on device).  Run on the GPU: python tools/profile_frame.py [C]
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

from rtsdr_tpu.config import MODE0  # noqa: E402
from rtsdr_tpu.pipeline.frame import frame_init, make_frame  # noqa: E402


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    cfg = MODE0
    rng = np.random.default_rng(0)
    rrc = jnp.asarray(rng.standard_normal((4, C, cfg.rds_len)).astype(np.float32))

    frame = jax.vmap(make_frame(cfg))
    st0 = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape).copy(),
        frame_init(cfg, jnp.float32))

    @jax.jit
    def step(state, x):
        out, st = frame(state, x, x)
        return st, out

    def run(k):
        st = jax.tree.map(lambda x: jnp.array(x, copy=True), st0)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for i in range(k):
            st, out = step(st, rrc[i % 4])
        float(jnp.sum(out.info_word[..., :1]))
        return time.perf_counter() - t0

    run(4)
    run(24)
    t1 = min(run(4) for _ in range(3))
    t2 = min(run(24) for _ in range(3))
    dt = (t2 - t1) / 20
    print(json.dumps({"channels": C, "frame_ms_per_step": round(dt * 1e3, 4),
                      "device": str(jax.devices()[0])}))


if __name__ == "__main__":
    main()
