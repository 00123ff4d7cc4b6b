"""Decompose the full-chain step time by toggling pipeline stages.

Slope-timed (see bench.py) at a given channel count; differences between
variants isolate the cost of the frame layer, the RDS DSP chain, and the
stereo path.  Run on the GPU:  python tools/profile_chain.py [channels]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtsdr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from bench import _bench_chain  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    variants = {
        "mono_only": dict(enable_rds=False, enable_stereo=False),
        "mono_stereo": dict(enable_rds=False, enable_stereo=True),
        "no_frame": dict(enable_rds=True, enable_stereo=True,
                         enable_frame=False),
        "full": dict(enable_rds=True, enable_stereo=True, enable_frame=True),
    }
    times = {}
    for name, kw in variants.items():
        r = _bench_chain(n, **kw)
        times[name] = r["sec_per_step"]
        print(json.dumps({"variant": name, "channels": n,
                          "sec_per_step": r["sec_per_step"],
                          "realtime_multiple": r["realtime_multiple"]}),
              flush=True)
    print(json.dumps({
        "channels": n,
        "mono_ms": round(times["mono_only"] * 1e3, 3),
        "stereo_extra_ms": round((times["mono_stereo"] - times["mono_only"]) * 1e3, 3),
        "rds_dsp_extra_ms": round((times["no_frame"] - times["mono_stereo"]) * 1e3, 3),
        "frame_extra_ms": round((times["full"] - times["no_frame"]) * 1e3, 3),
        "full_ms": round(times["full"] * 1e3, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
