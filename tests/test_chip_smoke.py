"""``chip_smoke.py`` pieces that run without a GPU: phase selection, the
last-line contract, the refusal to run on the CPU, and the ME near-tie
check."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_phase_selection():
    assert chip_smoke.select_phases(False) == (
        "device", "me-kernel", "fused-1080p", "adaptive-1080p", "cli", "intra-chroma",
    )
    assert chip_smoke.select_phases(True) == ("four-cards",)
    for name in chip_smoke.select_phases(False) + chip_smoke.select_phases(True):
        assert callable(chip_smoke.PHASES[name])


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.last_line([dev] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_refuses_cpu():
    import jax

    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])
    chip_smoke.require_gpu([SimpleNamespace(platform="gpu")])


def test_main_fails_before_any_phase_on_cpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_me_agreement_flags_only_real_gaps(rng):
    """Equal fields pass; a block moved to a worse candidate is measured."""
    from ivclab_tpu.ops.motion import motion_search

    ref = (rng.random((32, 32)) * 255).astype(np.float32)
    cur = np.roll(ref, (1, 2), (0, 1)).astype(np.float32)
    mv = np.asarray(motion_search(ref, cur, 4))
    same = chip_smoke.me_agreement(ref, cur, mv, mv, 4)
    assert same == {"blocks": 16, "differ": 0, "worst_rel_ssd_gap": 0.0}
    worse = mv.copy()
    worse[1, 1] = 40  # zero motion: a real SSD gap, not a near-tie
    g = chip_smoke.me_agreement(ref, cur, worse, mv, 4)
    assert g["differ"] == 1 and g["worst_rel_ssd_gap"] > chip_smoke.ME_SSD_RTOL
