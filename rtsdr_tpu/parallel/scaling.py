"""Scaling-efficiency harness: throughput vs mesh size.

Measures blocks/sec of the channel-sharded receiver at 1..N devices and
reports efficiency vs linear scaling (BASELINE.md target: >=80% at 1 chip /
1 host / N>=2 hosts).  On a machine with one accelerator this runs on the
virtual CPU mesh to validate the harness and the sharding's
communication-freeness; on several cards the same code measures real
scaling.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from rtsdr_tpu.config import ReceiverConfig
from rtsdr_tpu.parallel.channels import make_channel_sharded_receiver
from rtsdr_tpu.parallel.mesh import make_mesh


def measure_scaling(
    cfg: ReceiverConfig,
    channels_per_device: int = 8,
    device_counts: list[int] | None = None,
    k1: int = 3,
    k2: int = 9,
    **kwargs,
) -> list[dict]:
    """Weak-scaling sweep: channels grow with devices; returns one record
    per device count with blocks/s and efficiency vs the 1-device rate."""
    if device_counts is None:
        n = len(jax.devices())
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n]

    rng = np.random.default_rng(0)
    results = []
    base_rate = None
    for n_dev in device_counts:
        mesh = make_mesh(n_dev, 1)
        n_ch = channels_per_device * n_dev
        init_fn, step_fn, _ = make_channel_sharded_receiver(
            cfg, mesh, n_ch, jnp.float32, **kwargs)
        raw = rng.integers(0, 256, (n_ch, cfg.block_size), dtype=np.uint8)

        def run(k):
            state = init_fn()
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            for _ in range(k):
                state, out = step_fn(state, raw)
            float(jnp.sum(state.frontend.prev_i))
            return time.perf_counter() - t0

        run(k1), run(k2)

        def slope(a, b):
            return (min(run(b) for _ in range(2))
                    - min(run(a) for _ in range(2))) / (b - a)

        # on a loaded host a small-k slope can come out <= 0 (scheduling
        # noise exceeds the step cost): retry with a wider k spread, then
        # clamp AND flag so a junk rate can't silently poison base_rate
        # or the recorded efficiencies
        dt = slope(k1, k2)
        unreliable = False
        if dt <= 0:
            dt = slope(k1, 4 * k2 - 3 * k1)
        if dt <= 0:
            dt = 1e-9
            unreliable = True
        rate = n_ch / dt  # channel-blocks per second
        if base_rate is None and not unreliable:
            base_rate = rate / n_dev  # per-device baseline
        rec = {
            "devices": n_dev,
            "channels": n_ch,
            "channel_blocks_per_sec": rate,
            "efficiency": (rate / (base_rate * n_dev)
                           if base_rate is not None else None),
        }
        if unreliable:
            rec["unreliable"] = True
        results.append(rec)
    return results


if __name__ == "__main__":
    import json

    from rtsdr_tpu.config import MODE0

    for rec in measure_scaling(MODE0):
        print(json.dumps(rec))
