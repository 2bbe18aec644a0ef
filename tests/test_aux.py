"""Auxiliary-subsystem units: sanitize, profiler, settings, logging,
backend-demotion warnings (SURVEY §2.3 marshalling + §5.1/5.5/5.6)."""
import logging as pylogging
import math

import numpy as np
import pytest

from raytracevs_tpu.io.settings import AppSettings, SettingsService
from raytracevs_tpu.runtime.profiler import FrameStats, RenderProfiler
from raytracevs_tpu.scene.data import (
    CameraData, LightData, LightType, MaterialData, PlaneData, SceneData,
    SphereData,
)
from raytracevs_tpu.scene.sanitize import (
    sanitize_camera, sanitize_material, sanitize_scene,
)


# ---- sanitize (EngineWrapper.cpp:34-62,140-235 parity) ---------------------

def test_sanitize_material_clamps_and_falls_back():
    m = MaterialData(
        base_color=np.array([2.0, -1.0, float("nan"), 0.5]),
        metallic=float("inf"), roughness=7.0, transmission=-3.0,
        ior=9.5, specular=float("nan"),
        absorption=np.array([1000.0, float("nan"), -5.0]),
        emission=np.array([float("inf"), 1.0, 2.0, 0.0]),
    )
    s = sanitize_material(m)
    # clamps hit the bound; non-finite values take the per-field default
    assert s.base_color[0] == 1.0 and s.base_color[1] == 0.0
    assert s.base_color[2] == 0.8  # NaN -> default, not clamp bound
    assert s.metallic == 0.0       # inf -> default
    assert s.roughness == 1.0 and s.transmission == 0.0
    assert s.ior == 4.0            # IOR clamped to [1,4]
    assert s.specular == 0.5
    assert s.absorption[0] == 100.0 and s.absorption[1] == 0.0
    assert s.emission[0] == 0.0    # inf emission -> 0


def test_sanitize_scene_objects_and_lights():
    scene = SceneData()
    scene.objects.append(SphereData(position=np.array([1e9, 0.0, 0.0]),
                                    radius=-2.0))
    scene.objects.append(PlaneData(normal=np.zeros(3)))
    scene.lights.append(LightData(type=LightType.POINT,
                                  position=np.array([0.0, 5.0, 0.0]),
                                  intensity=1e9,
                                  soft_shadow_samples=99.0))
    out = sanitize_scene(scene)
    sph, pl = out.objects
    assert sph.position[0] == 10000.0       # clamped to +-10000
    assert sph.radius == 0.01               # non-positive radius -> 0.01
    assert np.allclose(pl.normal, [0.0, 1.0, 0.0])  # degenerate -> up
    light = out.lights[0]
    assert light.intensity == 1000.0
    assert light.soft_shadow_samples == 16.0


def test_sanitize_camera_fov_and_aperture():
    cam = CameraData()
    cam.field_of_view = 500.0
    cam.aperture_size = float("nan")
    cam.focus_distance = 0.0
    c = sanitize_camera(cam)
    assert c.field_of_view == 179.0
    assert c.aperture_size == 0.0
    assert c.focus_distance == 0.01
    assert math.isfinite(float(np.sum(c.position)))


# ---- profiler (SURVEY §5.1) ------------------------------------------------

def test_profiler_excludes_warmup_frame():
    prof = RenderProfiler()
    prof.record(1000.0, 10)   # first (compile) frame dropped
    prof.record(10.0, 1_000_000)
    prof.record(20.0, 2_000_000)
    assert len(prof.frames) == 2
    assert prof.mean_frame_ms == 15.0
    assert prof.best_frame_ms == 10.0
    assert prof.fps == pytest.approx(1000.0 / 15.0)
    s = prof.summary()
    assert s["frames"] == 2 and s["best_frame_ms"] == 10.0


def test_frame_stats_mrays():
    assert FrameStats(frame_ms=10.0, rays=5_000_000).mrays_per_s == 500.0
    assert FrameStats(frame_ms=0.0, rays=1).mrays_per_s == 0.0


# ---- settings (SettingsService.cs:9-70 parity) -----------------------------

def test_settings_roundtrip_and_unknown_keys(tmp_path):
    svc = SettingsService(directory=str(tmp_path))
    svc.settings.last_scene_file = "/tmp/x.rtvs"
    svc.settings.render_width = 1280
    svc.save()
    svc2 = SettingsService(directory=str(tmp_path))
    loaded = svc2.load()
    assert loaded.last_scene_file == "/tmp/x.rtvs"
    assert loaded.render_width == 1280
    # forward-compat: unknown keys in the file are ignored, not fatal
    import json
    data = json.loads(open(svc.path).read())
    data["future_field"] = 42
    open(svc.path, "w").write(json.dumps(data))
    assert SettingsService(directory=str(tmp_path)).load().render_width == 1280


def test_settings_missing_file_defaults(tmp_path):
    svc = SettingsService(directory=str(tmp_path / "nope"))
    assert svc.load() == AppSettings()


# ---- logging (DebugLog.h:9-99 analog) --------------------------------------

def test_warnings_and_errors_always_log(caplog):
    from raytracevs_tpu.utils import logging as rl

    with caplog.at_level(pylogging.DEBUG, logger="raytracevs_tpu"):
        rl.log_error("boom %d", 1)
        rl.log_warning("careful %s", "now")  # must NOT require opt-in
        rl.log_debug("hidden unless enabled")
    msgs = [r.getMessage() for r in caplog.records]
    assert "boom 1" in msgs
    assert "careful now" in msgs
    assert "hidden unless enabled" not in msgs
