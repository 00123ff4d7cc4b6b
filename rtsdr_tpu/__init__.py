"""rtsdr_tpu — a real-time software-defined FM radio framework on JAX (GPU).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
m1nty/Real-Time-Software-Defined-Radio (a McMaster 3DY4 real-time FM receiver:
RF front end -> FM discriminator -> mono/stereo audio + RDS decoding).

Design stance (see SURVEY.md):
  * The signal math follows the reference's *Python golden models*
    (reference model/fmMonoBlock.py, model/fmPll.py, model/fmRDSblock.py),
    not its C++ quirks.
  * Everything on the compute path is a pure, jittable, state-explicit
    function: ``step(state, iq_block) -> (state, outputs)``.
  * Throughput comes from batching many FM channels (vmap + mesh sharding)
    and from matmul-shaped FIR formulations, not from thread pipelines.

Package layout:
  config    — frozen mode tables (mode 0 / mode 1), mirroring the constants at
              reference src/fm_radio.cpp:34-55,152-180,330-370
  ops       — DSP kernel library (layer L2 of SURVEY.md): coeffs, FIR,
              discriminator, PLL (+ its GPU Pallas kernel), PSD
  pipeline  — the streaming signal-flow graph (layer L3): mono, stereo, RDS,
              frame sync; explicit state pytrees
  parallel  — mesh / sharding: channel-parallel + time-block sharding with
              halo exchange
  io        — host ingest/emit (uint8 IQ in, int16 audio out), native runtime
  utils     — observability: PSD logging, profiling, golden-model oracles
"""

__version__ = "0.1.0"

from rtsdr_tpu import config  # noqa: F401
