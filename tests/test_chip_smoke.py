"""``chip_smoke.py``'s phases at tiny widths on the CPU.

On the card ``python chip_smoke.py`` runs them at fleet width; here each
phase runs the same code on a few channels and short blocks, so a broken
phase shows before it reaches the card.  Only ``main`` insists on a GPU.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    """Off a GPU: non-zero exit and no result line on stdout."""
    assert cs.main(argv) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs a GPU" in err


def test_phase_card(capsys):
    info = cs.phase_card()
    assert info["jax"] == jax.__version__
    assert info["native_runtime"] in ("loaded", "numpy fallback")
    assert info["compile_cache"]
    line = capsys.readouterr().out.strip()
    assert json.loads(line.split(" ", 1)[1]) == info


def test_phase_station(tmp_path):
    """CLI in-process: syndromes 26 apart, both tones, events == f64."""
    res = cs.phase_station(tmp_path, n_blocks=4)
    assert res["events_equal_f64"] and res["syncs"] >= 8


def test_phase_fleet():
    res = cs.phase_fleet(n_channels=2, n_blocks=2, n_check=2, n_timed=1)
    assert res["max_audio_diff"] <= res["bound"] == cs.AUDIO_LSB
    assert res["steps_per_s"] > 0


def test_phase_mode1_rds():
    res = cs.phase_mode1_rds(n_channels=2, n_blocks=1, n_check=1)
    assert res["max_audio_diff"] <= cs.AUDIO_LSB


def test_phase_wideband():
    res = cs.phase_wideband(k=2, slot=1)
    assert res["max_audio_diff_vs_pfb"] <= cs.WIDEBAND_ATOL


def test_phase_four_on_cpu_mesh():
    """The --four phase on four virtual CPU devices."""
    res = cs.phase_four(n_channels=8, n_blocks=1, n_devices=4)
    for part in ("channel_sharded", "time_sharded"):
        assert res[part]["max_audio_diff"] <= cs.AUDIO_LSB


def test_phase_four_needs_devices():
    with pytest.raises(AssertionError, match="devices"):
        cs.phase_four(n_channels=8, n_blocks=1,
                      n_devices=len(jax.devices()) + 1)


def _outs(audio, synd):
    return [(np.full((2, 8), audio), np.zeros((2, 8)), np.asarray(synd))]


@pytest.mark.parametrize("ours,match", [
    (_outs(1e-3, [[1, 2]] * 2), "audio off"),
    (_outs(0.0, [[1, 3]] * 2), "syndromes differ"),
])
def test_compare_fails_loudly(ours, match):
    ref = _outs(0.0, [[1, 2]] * 2)
    with pytest.raises(AssertionError, match=match):
        cs.compare(ours, ref, cs.AUDIO_LSB, "t")


def test_compare_within_bound():
    res = cs.compare(_outs(cs.AUDIO_LSB / 2, [[1, 2]] * 2),
                     _outs(0.0, [[1, 2]] * 2), cs.AUDIO_LSB, "t")
    assert res["max_audio_diff"] == cs.AUDIO_LSB / 2


def test_tone_amp():
    t = np.arange(48000) / 48e3
    assert cs.tone_amp(0.7 * np.sin(2 * np.pi * 1.1e3 * t + 0.3),
                       1.1e3) == pytest.approx(0.7, abs=1e-6)


def test_fleet_raw_tiles_distinct_stations():
    from rtsdr_tpu.config import MODE0

    raw = cs.fleet_raw(MODE0, 5, 1, 2)
    assert raw.shape == (5, MODE0.block_size) and raw.dtype == np.uint8
    assert not np.array_equal(raw[0], raw[1])
    np.testing.assert_array_equal(raw[0], raw[2])
    np.testing.assert_array_equal(raw[1], raw[3])
