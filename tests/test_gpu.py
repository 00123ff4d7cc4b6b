"""GPU paths at fleet width, compared once with their references.

Marked ``gpu``: the ``gpu_device`` fixture skips them off a card (see
conftest.py for how to run them on one).  ``python chip_smoke.py`` runs
the same checks as part of its phases.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from rtsdr_tpu.config import MODE0
from rtsdr_tpu.ops.pll import pll, pll_init

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]


def test_pll_kernel_compiled_matches_scan(gpu_device):
    """The compiled Triton PLL kernel at 2 x 1024 lanes over one mode-0
    block against ``lax.scan`` (tolerance: tests/test_pll_kernel.py)."""
    n, c = MODE0.if_len, 1024
    t = np.arange(n) / MODE0.rf.if_fs
    ph = np.random.default_rng(0).uniform(0, 2 * np.pi, (2, c, 1))
    x = jnp.asarray(np.cos(2 * np.pi * np.array([19e3, 114e3])[:, None, None]
                           * t + ph), jnp.float32)
    kw = dict(freq=np.array([19e3, 114e3]).reshape(2, 1), fs=MODE0.rf.if_fs,
              nco_scale=np.array([2.0, 0.5]).reshape(2, 1),
              norm_bandwidth=np.array([0.01, 0.001]).reshape(2, 1))
    ours = pll(x, pll_init((2, c)), impl="kernel", **kw)
    ref = pll(x, pll_init((2, c)), impl="scan", **kw)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5)


def test_fleet_full_chain_matches_f64(gpu_device):
    """chip_smoke's fleet phase: 1024 channels, 4 against the f64 oracle."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    res = chip_smoke.phase_fleet(n_channels=1024, n_blocks=2, n_check=4,
                                 n_timed=1)
    assert res["max_audio_diff"] <= chip_smoke.AUDIO_LSB
