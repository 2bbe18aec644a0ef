"""Golden-image SSIM tests over the BASELINE configs (SURVEY §4/§6).

Config 1: sample_scene geometry, point light, hard shadows.
Config 2: box OBB + directional/ambient + Fresnel mirror bounce, Reinhard.
Config 3: BSDF transmission/IOR + Beer-Lambert colored shadows + soft area
          shadows.
Config 4: triangle mesh (the generated wine glass) via BVH + GGX roughness
          perturbation.
Config 5: photon-mapped caustics + denoiser + ACES + DoF, multi-frame.

Goldens live in tests/golden/*.png and regenerate via
`python tests/test_golden.py --regen` (review the images before committing).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SSIM_THRESHOLD = 0.98
RES = 96


def _engine_for(config_name, res=None):
    from raytracevs_tpu import Engine
    from raytracevs_tpu.io.mesh_cache import MeshCacheService
    from raytracevs_tpu.scene.data import (
        BoxData, LightData, LightType, MaterialData, MeshObjectData, PlaneData,
        SceneData, SphereData,
    )
    from raytracevs_tpu.scene.transform import Transform, euler_deg_to_quat, obb_axes_from_quat

    scene = SceneData()
    scene.camera.position = np.array([0.0, 2.0, -5.0])
    scene.camera.look_at = np.array([0.0, 1.0, 0.0])
    scene.settings.samples_per_pixel = 2
    scene.settings.max_bounces = 6
    scene.settings.tone_map_operator = 2
    mesh_service = None
    overrides = {}

    if config_name == "config1_hard_shadows":
        scene.objects += [
            SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                      intensity=8.0)
        ]
    elif config_name == "config2_obb_mirror":
        q = euler_deg_to_quat([0, 30, 0])
        ax, ay, az = obb_axes_from_quat(q)
        mirror = MaterialData(metallic=1.0, roughness=0.0)
        scene.objects += [
            BoxData(center=np.array([0.0, 1.0, 0.0]), size=np.array([0.6, 1.0, 0.6]),
                    axis_x=ax, axis_y=ay, axis_z=az, material=mirror),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.DIRECTIONAL, direction=np.array([0.4, -1.0, 0.3]),
                      intensity=1.0),
            LightData(type=LightType.AMBIENT, color=np.array([0.25, 0.25, 0.25, 1.0])),
        ]
        scene.settings.tone_map_operator = 0  # Reinhard
    elif config_name == "config3_glass_soft":
        glass = MaterialData(transmission=0.9, ior=1.5, roughness=0.0,
                             absorption=np.array([0.1, 1.2, 1.2]))
        scene.objects += [
            SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.9, material=glass),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.POINT, position=np.array([2.0, 6.0, -2.0]),
                      intensity=15.0, radius=0.4, soft_shadow_samples=4),
            LightData(type=LightType.AMBIENT, color=np.array([0.2, 0.2, 0.2, 1.0])),
        ]
    elif config_name == "config4_mesh":
        mesh_service = MeshCacheService()  # the generated wine glass
        glass = MaterialData(base_color=np.array([0.95, 0.95, 0.95, 1.0]),
                             transmission=1.0, ior=1.05, roughness=0.1)
        # stand the glass (modeled along -Z) upright, 2 units tall
        t = Transform(rotation=euler_deg_to_quat([90, 0, 0]),
                      scale=np.array([0.2, 0.2, 0.2]))
        scene.objects += [
            MeshObjectData(mesh_name="WineGlass2", transform=t, material=glass),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                      intensity=10.0),
            LightData(type=LightType.AMBIENT, color=np.array([0.3, 0.3, 0.3, 1.0])),
        ]
        scene.camera.position = np.array([0.0, 1.5, -3.5])
        scene.camera.look_at = np.array([0.0, 0.9, 0.0])
    elif config_name == "config5_caustics_denoise":
        glass = MaterialData(transmission=0.9, ior=1.5, roughness=0.0)
        scene.objects += [
            SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.8, material=glass),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.POINT, position=np.array([0.0, 6.0, 0.0]),
                      intensity=20.0)
        ]
        scene.settings.enable_caustics = True
        scene.settings.enable_denoiser = True
        scene.settings.tone_map_operator = 1  # ACES
        scene.camera.aperture_size = 0.05
        scene.camera.focus_distance = 5.0
        scene.settings.samples_per_pixel = 2
    elif config_name == "config6_soft_shadows":
        # multi-sample soft shadows with the TDR clamp lifted
        # (Common.hlsli:1199-1357 allows 1-16; DXRPipeline.cpp:928 clamps
        # to 1 — the max_soft_samples override unlocks the full contract)
        scene.objects += [
            SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0),
            PlaneData(),
        ]
        scene.lights += [
            LightData(type=LightType.POINT, position=np.array([2.5, 4.0, -2.0]),
                      intensity=10.0, radius=1.0, soft_shadow_samples=8),
            LightData(type=LightType.AMBIENT, color=np.array([0.15, 0.15, 0.15, 1.0])),
        ]
        overrides["max_soft_samples"] = 8
    else:
        raise ValueError(config_name)

    res = RES if res is None else res
    engine = Engine(res, res, mesh_service=mesh_service)
    engine.update_scene(scene, **overrides)
    return engine


CONFIGS = [
    "config0_sample_scene",
    "config1_hard_shadows",
    "config2_obb_mirror",
    "config3_glass_soft",
    "config4_mesh",
    "config5_caustics_denoise",
    "config6_soft_shadows",
]


def _render(config_name, res=RES):
    if config_name == "config0_sample_scene":
        from raytracevs_tpu import Engine

        from conftest import analytic_scene_file

        engine = Engine(res, res)
        engine.load_rtvs(analytic_scene_file(),
                         samples_per_pixel=2, max_bounces=6)
        return engine.render()
    engine = _engine_for(config_name, res=res)
    img = engine.render()
    if config_name == "config5_caustics_denoise":
        for _ in range(2):  # multi-frame (temporal accumulation)
            img = engine.render()
    return img


def _golden_path(config_name, res=RES):
    suffix = "" if res == RES else f"_{res}"
    return os.path.join(GOLDEN_DIR, config_name + suffix + ".png")


def _check_golden(config_name, res):
    from PIL import Image

    from raytracevs_tpu.utils.ssim import ssim

    path = _golden_path(config_name, res)
    if not os.path.exists(path):
        pytest.skip(f"golden missing: {path} (regen with tests/test_golden.py --regen)")
    golden = np.asarray(Image.open(path).convert("RGBA"))
    img = _render(config_name, res)
    score = ssim(img, golden)
    assert score >= SSIM_THRESHOLD, f"{config_name}@{res}: SSIM {score:.4f} < {SSIM_THRESHOLD}"


@pytest.mark.parametrize("config_name", CONFIGS)
def test_golden(config_name):
    _check_golden(config_name, RES)


@pytest.mark.nightly
@pytest.mark.parametrize("config_name", CONFIGS)
def test_golden_256(config_name):
    """Nightly 256x256 tier: thin features (the wine-glass stem, checker
    edges, the caustic ring) are sub-pixel at 96px, so regressions there
    slipped the fast goldens (VERDICT r3 weak #2)."""
    _check_golden(config_name, 256)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from PIL import Image

        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name in CONFIGS:
            for res in (RES, 256):
                img = _render(name, res)
                Image.fromarray(img).save(_golden_path(name, res))
                print("wrote", _golden_path(name, res))
