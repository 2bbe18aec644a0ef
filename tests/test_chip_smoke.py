"""chip_smoke.py: its phases run end to end on the CPU at a tiny size, and
its main() refuses to run without a GPU (no CPU fallback)."""
import os
import sys

import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

W, H = 16, 8


@pytest.fixture(scope="module")
def scene():
    from conftest import analytic_scene_file

    return analytic_scene_file()


def test_main_refuses_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "FAIL device" in out and '"ok"' not in out


def test_offline_phase(scene, tmp_path):
    res = cs.phase_offline(W, H, scene, str(tmp_path), frames=2)
    assert res["rays_per_frame"] > 0 and res["steady_ms"] is not None
    assert (tmp_path / "offline.png").exists()


def test_interactive_phase(scene, tmp_path):
    res = cs.phase_interactive(W, H, scene, str(tmp_path), frames=3)
    assert res["steady_ms"] is not None
    assert "temp_size_in_bytes" in res["memory_analysis"]


def test_caustics_phase(scene, tmp_path):
    res = cs.phase_caustics(W, H, scene, str(tmp_path))
    assert res["photons"] > 0 and res["caustic_pixels"] > 0


def test_parity_phase_against_itself(scene):
    """Card and reference are both the CPU here: every comparison is exact."""
    res = cs.phase_parity(W, H, scene, rows=8, frames=2,
                          ref_device=jax.devices()[0])
    assert res["slab_hdr"]["within"] == 1.0
    assert res["denoise1_diffuse"]["mean_abs_rel"] == 0.0


def test_compare_flags_mismatch():
    import numpy as np

    ref = np.ones((1000, 3))
    got = ref.copy()
    got[:10] += 0.5  # 1% of pixels off
    with pytest.raises(cs.SmokeFailure):
        cs.compare("x", got, ref)
    got = ref.copy()
    got[:4] += 0.5  # 0.4% off, mean error 2e-3 of the mean
    with pytest.raises(cs.SmokeFailure):
        cs.compare("x", got, ref)
    assert cs.compare("x", ref + 1e-4, ref)["within"] == 1.0


def test_validate_phase(scene):
    assert cs.phase_validate(W, H, scene)["ok"]
