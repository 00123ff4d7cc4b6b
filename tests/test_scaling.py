"""Scaling harness sanity on the virtual CPU mesh.

CPU "devices" share physical cores, so absolute efficiency numbers are
meaningless here; this validates that the harness runs, shards correctly,
and reports coherent records.  Real numbers come from runs on several
cards.
"""

from rtsdr_tpu.config import MODE0
from rtsdr_tpu.parallel.scaling import measure_scaling


def test_scaling_harness_runs():
    recs = measure_scaling(MODE0, channels_per_device=1,
                           device_counts=[1, 2], k1=1, k2=2,
                           enable_rds=False, enable_stereo=False)
    assert len(recs) == 2
    assert recs[0]["devices"] == 1 and recs[1]["devices"] == 2
    assert recs[1]["channels"] == 2
    assert recs[0]["efficiency"] == 1.0
    assert recs[1]["channel_blocks_per_sec"] > 0

