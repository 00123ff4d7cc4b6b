"""Dump the standard debug probe set as gnuplot .dat files.

The reference's debug workflow is: run the chain, logVector key probe
points into data/*.dat, and inspect with src/example.gnuplot (PSDs are the
primary verification method where no exact oracle exists — SURVEY.md §4).
This tool reproduces that workflow end to end for this receiver:

    python tools/dump_diagnostics.py [capture.u8 | --synth N] [--out data]
    gnuplot -p tools/example.gnuplot        # (run from the repo root)

Probe points dumped (reference equivalents: src/fm_radio.cpp logVector
calls and model/fmRdsBasic.py plots):
  demod_psd.dat    FM-demodulated multiplex PSD at the IF rate — pilot at
                   19 kHz, stereo DSB around 38 kHz, RDS around 57 kHz
  audio_psd.dat    decoded mono audio PSD at 48 kS/s
  rrc.dat/rrcQ.dat RRC matched-filter output time traces (I and Q)
  constellation.dat  RDS I/Q symbol scatter (see tools/constellation.py)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("capture", nargs="?", default=None)
    p.add_argument("--synth", type=int, default=None, metavar="BLOCKS")
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--out", default="data")
    p.add_argument("--nfft", type=int, default=512)
    args = p.parse_args(argv)

    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat.split(",")[0])

    import jax
    import jax.numpy as jnp
    import numpy as np

    from constellation import _synth_station, collect_symbols, log_scatter
    from rtsdr_tpu.config import MODE0
    from rtsdr_tpu.pipeline.frontend import frontend_init, make_frontend
    from rtsdr_tpu.pipeline.receiver import make_receiver
    from rtsdr_tpu.utils.logging import log_psd, log_vector

    cfg = MODE0
    if args.synth is not None:
        n_blocks = args.synth
        iq = _synth_station(n_blocks, cfg)
    elif args.capture:
        iq = np.fromfile(args.capture, dtype=np.uint8)
        n_blocks = len(iq) // cfg.block_size
        if args.blocks:
            n_blocks = min(n_blocks, args.blocks)
    else:
        p.error("provide a capture file or --synth BLOCKS")

    bs = cfg.block_size

    # demodulated multiplex (front end only)
    frontend = jax.jit(make_frontend(cfg, jnp.float32))
    fe_state = frontend_init(cfg, (), jnp.float32)
    fms = []
    for b in range(n_blocks):
        fm, fe_state = frontend(fe_state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
        fms.append(np.asarray(fm))
    fm_all = np.concatenate(fms)[cfg.if_len:]  # skip warmup block
    log_psd("demod_psd", fm_all, args.nfft, cfg.rf.if_fs, args.out)

    # full receiver: audio + RRC streams
    init_fn, step_fn = make_receiver(cfg, dtype=jnp.float32,
                                     enable_frame=False)
    step = jax.jit(step_fn)
    state = init_fn()
    mono, rrc_i, rrc_q = [], [], []
    for b in range(n_blocks):
        state, out = step(state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
        mono.append(np.asarray(out.mono))
        rrc_i.append(np.asarray(out.rds[0]))
        rrc_q.append(np.asarray(out.rds[1]))
    log_psd("audio_psd", np.concatenate(mono)[cfg.audio_len:], args.nfft,
            cfg.audio_fs, args.out)
    log_vector("rrc", rrc_i[-1][:512], out_dir=args.out)
    log_vector("rrcQ", rrc_q[-1][:512], out_dir=args.out)

    # constellation (frame layer's symbol slicer)
    si, sq = collect_symbols(iq, cfg, n_blocks, skip=min(2, n_blocks - 1))
    log_scatter("constellation", si, sq, args.out)

    print(f"wrote demod_psd, audio_psd, rrc, rrcQ, constellation .dat "
          f"to {args.out}/ — view with: gnuplot -p tools/example.gnuplot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
