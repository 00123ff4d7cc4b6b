"""Mesh sharding (SURVEY.md §2c).

The reference's parallelism is a 4-stage pthread pipeline over one FM
channel (src/fm_radio.cpp:783-792).  On a device mesh the axes are different:

  * ``channel`` (data parallel): many FM stations, embarrassingly parallel —
    a sharded batch dimension over the mesh.
  * ``time`` (sequence parallel): one station's sample stream split into
    chunks; FIR overlap-save tails become `ppermute` halo exchanges between
    devices, and the PLL recurrence pipelines its state shard-to-shard.
"""

from rtsdr_tpu.parallel.mesh import make_mesh  # noqa: F401
from rtsdr_tpu.parallel.channels import make_channel_sharded_receiver  # noqa: F401
