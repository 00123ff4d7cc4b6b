"""RDS at the mode-1 rates — beyond the reference, which gates its RDS
thread on mode==0 (src/fm_radio.cpp:324) although the 250 kS/s IF still
carries the 57 kHz subcarrier.  MODE1_RDS resamples x57/250 to the same
57 kS/s symbol grid (24 samples/symbol), with phase_adjust retuned for the
mode-1 group delays (config.py MODE1_RDS note).
"""

import jax
import jax.numpy as jnp
import numpy as np

from oracles import encode_rds_blocks, rds_baseband, synth_multiplex_iq
from rtsdr_tpu.config import MODE1_RDS
from rtsdr_tpu.pipeline.groups import GroupDecoder
from rtsdr_tpu.pipeline.receiver import make_receiver
from test_groups import _CT_DATE, _make_station_groups


def test_mode1_rds_decodes_groups():
    assert MODE1_RDS.rds_len == 3648           # exact 57 kS/s grid
    assert MODE1_RDS.rds_len % MODE1_RDS.rds.sps == 0

    n_blocks = 14
    words = _make_station_groups(40 * n_blocks)
    wave = rds_baseband(encode_rds_blocks(words))
    iq = synth_multiplex_iq(n_blocks * MODE1_RDS.block_size // 2,
                            rf_fs=2.5e6, rds_wave=wave,
                            rng=np.random.default_rng(0x6A))
    init_fn, step_fn = make_receiver(MODE1_RDS, dtype=jnp.float32,
                                     use_abs_clock=True)
    step = jax.jit(step_fn)
    state = init_fn()
    dec = GroupDecoder()
    bs = MODE1_RDS.block_size
    for b in range(n_blocks):
        state, out = step(state, jnp.asarray(iq[b * bs:(b + 1) * bs]))
        dec.feed(out.rds)

    assert len(dec.groups) >= 7, f"only {len(dec.groups)} groups assembled"
    assert dec.pi == 0x3A5C
    assert dec.ps_name == "JAX RDIO"
    assert dec.clock is not None
    assert (dec.clock.year, dec.clock.month, dec.clock.day) == _CT_DATE[:3]
    # continuous decode: consecutive syncs stay on the 26-bit lattice
    positions = [g.position for g in dec.groups]
    assert np.all(np.diff(positions) % 26 == 0)
