"""Record scaling artifacts: single-card channel sweep + CPU-mesh weak
scaling -> one JSON file (default scaling.json).

Card part (default): sweep channel counts for the mono and full chains,
locate the real-time capacity knee (max channels decodable in real time on
one card) and the single-station block latency.

CPU part (--cpu-mesh): weak-scaling records from parallel.scaling on the
virtual 8-device mesh — relative numbers only (virtual devices share
physical cores), recorded to validate the harness shape.

Usage:  python tools/scaling_sweep.py [--out scaling.json]
        python tools/scaling_sweep.py --cpu-mesh [--out ...]   (merges in)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_sweep():
    import jax

    from rtsdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import _bench_chain

    records = {"device": str(jax.devices()[0]), "mono": [], "full": []}
    for chain, kw in (("mono", dict(enable_rds=False, enable_stereo=False)),
                      ("full", {})):
        for n_ch in ((1, 64, 128, 256, 512, 1024, 2048)
                     if chain == "mono" else (1, 64, 128, 256, 512, 1024)):
            r = _bench_chain(n_ch, **kw)
            rec = {
                "channels": n_ch,
                "ms_per_step": round(r["sec_per_step"] * 1e3, 4),
                "realtime_multiple": round(r["realtime_multiple"], 1),
                "iq_msamples_per_sec": round(r["iq_msamples_per_sec"], 1),
            }
            records[chain].append(rec)
            print(json.dumps({"chain": chain, **rec}), flush=True)

    # capacity knee: channels/step-time keeps rising while the card has
    # headroom; the real-time capacity is channels * realtime_multiple /
    # channels... i.e. realtime_multiple itself (it already counts
    # channels).  Report the best observed and the 1-channel latency.
    for chain in ("mono", "full"):
        best = max(records[chain], key=lambda r: r["realtime_multiple"])
        records[f"{chain}_best"] = best
        one = records[chain][0]
        records[f"{chain}_single_station_latency_ms"] = one["ms_per_step"]
    return records


def cpu_mesh_records():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from rtsdr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.parallel.scaling import measure_scaling

    recs = measure_scaling(MODE0, channels_per_device=4,
                           device_counts=[1, 2, 4, 8],
                           enable_rds=False, enable_stereo=False)
    for r in recs:
        print(json.dumps(r), flush=True)
    return {
        "note": ("virtual CPU devices share physical cores; numbers are "
                 "relative shape-validation only, not card scaling"),
        "records": recs,
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="scaling.json")
    p.add_argument("--cpu-mesh", action="store_true")
    args = p.parse_args()

    data = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            data = json.load(f)

    if args.cpu_mesh:
        data["cpu_mesh_weak_scaling"] = cpu_mesh_records()
    else:
        data["single_card"] = card_sweep()

    with open(args.out, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
