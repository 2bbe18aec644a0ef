#!/usr/bin/env python
"""Benchmark: the canonical scene (assets/sample_scene.rtvs) on one GPU.

Prints ONE JSON line. The headline is the throughput on the canonical
scene at its scene-carried settings (denoiser off: raw path-tracer
throughput); extra keys cover the rest of BASELINE.md's metric set:

  frame_ms / fps              headline config
  default_frame_ms/default_fps the DEFAULT pipeline, denoiser ON
  fast_fps / fast_frame_ms    spp=1, bounces=5 (the reference's defaults,
                              README.md:228) with the denoiser on: the
                              interactive configuration
  fast_fps_720p / _1440p / _4k the same config at the reference README's
                              other FPS-ladder rungs (README.md:304-307)
  caustics*_frame_ms          the photon pass at the scene's own budget and
                              at the 131,072-photon safe cap
  mesh_* / mesh_opaque_*      the generated 5.9k-triangle wine glass alone
                              (BVH path), as glass and opaque
  big_mesh_*                  a ~200k-triangle procedural sphere

Every timing is the best of BENCH_FRAMES frames of the jitted frame step,
each ended by block_until_ready; compilation is reported apart as
set-up. The output names the device (platform, device_kind, count) and the
card's name and power limit from nvidia-smi. Refuses to run without a GPU.

    python bench.py    # BENCH_WIDTH / BENCH_HEIGHT / BENCH_FRAMES override
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.environ.get("BENCH_SCENE",
                       os.path.join(REPO, "assets", "sample_scene.rtvs"))


def _nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return proc.stdout.strip().replace("\n", " | ")


def _bench_config(engine, cfg, reps):
    """Time the full engine pipeline (denoise included when cfg says so).

    Returns (best seconds per frame, mean rays per frame, compile seconds).
    Each frame is one call of the jitted frame step with the temporal state
    carried; want_aux=False keeps only the RGBA image and ray count."""
    import jax
    import jax.numpy as jnp

    from raytracevs_tpu.post import denoise as denoise_mod
    from raytracevs_tpu.runtime.engine import _render_pipeline

    state = (denoise_mod.init_state(cfg.height, cfg.width)
             if cfg.enable_denoiser else None)
    flat = engine._flat

    def frame(i, st):
        s_i = flat._replace(frame_index=jnp.uint32(i))
        rgba, _hdr, rays, _g, st, _dn = _render_pipeline(s_i, cfg, st, False)
        jax.block_until_ready(rgba)
        return rays, st

    t0 = time.perf_counter()
    _rays, state = frame(0, state)  # compile + first frame
    compile_s = time.perf_counter() - t0
    times, ray_counts = [], []
    for r in range(reps):
        t0 = time.perf_counter()
        rays, state = frame(r + 1, state)
        times.append(time.perf_counter() - t0)
        ray_counts.append(float(rays))
    return min(times), sum(ray_counts) / len(ray_counts), compile_s


def _big_mesh_engine(width, height, rings=316, segs=316):
    """~200k-triangle procedural sphere, opaque, over the floor."""
    import numpy as np

    from raytracevs_tpu.io.mesh_cache import CachedMesh, MeshCacheService
    from raytracevs_tpu.runtime.engine import Engine
    from raytracevs_tpu.scene.data import (
        LightData, LightType, MaterialData, MeshObjectData, PlaneData, SceneData,
    )

    th = np.pi * np.arange(rings + 1) / rings
    ph = 2.0 * np.pi * np.arange(segs + 1) / segs
    n = np.stack([np.outer(np.sin(th), np.cos(ph)),
                  np.outer(np.cos(th), np.ones_like(ph)),
                  np.outer(np.sin(th), np.sin(ph))], axis=-1).reshape(-1, 3)
    verts = np.zeros((len(n), 8), np.float32)
    verts[:, 0:3] = 0.9 * n
    verts[:, 4:7] = n
    a = (np.arange(rings)[:, None] * (segs + 1) + np.arange(segs)[None, :]).reshape(-1)
    b = a + segs + 1
    idx = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=1).reshape(-1)
    ms = MeshCacheService()
    ms.register("BigSphere", CachedMesh(
        name="BigSphere", vertices=verts.reshape(-1),
        indices=idx.astype(np.uint32),
        bounds_min=np.array([-0.9, -0.9, -0.9]),
        bounds_max=np.array([0.9, 0.9, 0.9]),
    ))
    scene = SceneData()
    scene.camera.position = np.array([0.0, 1.2, -3.0])
    scene.camera.look_at = np.array([0.0, 0.8, 0.0])
    scene.settings.samples_per_pixel = 1
    scene.settings.max_bounces = 6
    scene.settings.enable_denoiser = False
    scene.objects += [
        MeshObjectData(mesh_name="BigSphere",
                       material=MaterialData(
                           base_color=np.array([0.8, 0.5, 0.3, 1.0]),
                           roughness=0.5)),
        PlaneData(),
    ]
    scene.lights += [
        LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                  intensity=10.0),
        LightData(type=LightType.AMBIENT,
                  color=np.array([0.3, 0.3, 0.3, 1.0])),
    ]
    engine = Engine(width, height, mesh_service=ms)
    engine.update_scene(scene)
    return engine


def _mesh_engine(width, height, material="glass"):
    """The canonical scene's wine glass alone over the floor."""
    import numpy as np

    from raytracevs_tpu.io.mesh_cache import MeshCacheService
    from raytracevs_tpu.runtime.engine import Engine
    from raytracevs_tpu.scene.data import (
        LightData, LightType, MaterialData, MeshObjectData, PlaneData, SceneData,
    )
    from raytracevs_tpu.scene.transform import Transform, euler_deg_to_quat

    scene = SceneData()
    scene.camera.position = np.array([0.0, 1.5, -3.5])
    scene.camera.look_at = np.array([0.0, 0.9, 0.0])
    scene.settings.samples_per_pixel = 1
    scene.settings.max_bounces = 6
    scene.settings.enable_denoiser = False
    if material == "glass":
        mat = MaterialData(base_color=np.array([0.95, 0.95, 0.95, 1.0]),
                           transmission=1.0, ior=1.05, roughness=0.1)
    else:  # opaque: pure BVH traversal throughput (no specular path trees)
        mat = MaterialData(base_color=np.array([0.85, 0.85, 0.9, 1.0]),
                           roughness=0.4)
    # the glass is modeled along -Z: stand it upright, 2 units tall
    scene.objects += [
        MeshObjectData(mesh_name="WineGlass2",
                       transform=Transform(rotation=euler_deg_to_quat([90, 0, 0]),
                                           scale=np.array([0.2, 0.2, 0.2])),
                       material=mat),
        PlaneData(),
    ]
    scene.lights += [
        LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                  intensity=10.0),
        LightData(type=LightType.AMBIENT, color=np.array([0.3, 0.3, 0.3, 1.0])),
    ]
    engine = Engine(width, height, mesh_service=MeshCacheService())
    engine.update_scene(scene)
    return engine


def run(width, height, frames) -> dict:
    """Every section at the given size; returns the result dict."""
    import jax

    from raytracevs_tpu.ops.photon import photon_budget
    from raytracevs_tpu.runtime.engine import Engine
    from raytracevs_tpu.scene.flatten import make_config

    compile_s = {}

    def bench_cfg(tag, engine, cfg, reps=frames):
        best_s, rays, compile_s[tag] = _bench_config(engine, cfg, reps)
        return best_s, rays

    dev = jax.devices()[0]
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "nvidia_smi": _nvidia_smi()}

    # 1) headline: scene-carried settings, denoiser off (raw throughput)
    engine = Engine(width, height, device_mesh=None)
    engine.load_rtvs(SCENE, enable_denoiser=False)
    best_s, mean_rays = bench_cfg("headline", engine, engine._cfg)
    mrays = mean_rays / best_s / 1e6
    result.update({
        "metric": f"Mrays/s on sample_scene.rtvs @{width}x{height}",
        "value": mrays,
        "unit": "Mrays/s",
        "frame_ms": best_s * 1000.0,
        "fps": 1.0 / best_s,
        "rays_per_frame": int(mean_rays),
        "spp": engine._cfg.samples_per_pixel,
        "max_bounces": engine._cfg.max_bounces,
    })

    # 2) DEFAULT pipeline: denoiser ON (the data.py default) — full frame
    cfg_def = make_config(engine._scene, width, height, enable_denoiser=True)
    best_s, _ = bench_cfg("default", engine, cfg_def)
    result["default_frame_ms"] = best_s * 1000.0
    result["default_fps"] = 1.0 / best_s

    # 3) interactive config: reference defaults spp=1 bounces=5, denoiser on
    cfg_fast = make_config(engine._scene, width, height, samples_per_pixel=1,
                           max_bounces=5, enable_denoiser=True)
    best_s, fast_rays = bench_cfg("fast", engine, cfg_fast)
    result["fast_frame_ms"] = best_s * 1000.0
    result["fast_fps"] = 1.0 / best_s
    result["fast_mrays"] = fast_rays / best_s / 1e6

    # 3b) resolution scaling of the interactive config — BASELINE.md's FPS
    # table rows (README.md:304-307)
    for label, (rw, rh) in (("720p", (1280, 720)), ("1440p", (2560, 1440)),
                            ("4k", (3840, 2160))):
        rw, rh = rw * width // 1920, rh * height // 1080
        eng_r = Engine(rw, rh, device_mesh=None)
        eng_r.load_rtvs(SCENE, enable_denoiser=True, samples_per_pixel=1,
                        max_bounces=5)
        best_s, _ = bench_cfg(f"fast_{label}", eng_r, eng_r._cfg)
        result[f"fast_fps_{label}"] = 1.0 / best_s

    # 3c) caustics at the reference's own budget for this scene
    # (DXRPipeline.cpp:3604-3633 TDR caps) and at its global 131,072-photon
    # safe cap (DXRPipeline.h:483-487): frame time with the photon pass on,
    # and the delta against the same config with it off.
    base_cfg = make_config(engine._scene, width, height, samples_per_pixel=1,
                           max_bounces=5, enable_denoiser=False)
    best_off, _ = bench_cfg("caustics_off", engine, base_cfg)
    for tag, n_ph in (("", photon_budget(engine._scene)), ("_max", 131072)):
        if n_ph <= 0:
            continue
        cfg_c = base_cfg._replace(num_photons=n_ph)
        best_s, _ = bench_cfg(f"caustics{tag}", engine, cfg_c)
        result[f"caustics{tag}_photons"] = n_ph
        result[f"caustics{tag}_frame_ms"] = best_s * 1000.0
        result[f"caustics{tag}_delta_ms"] = (best_s - best_off) * 1000.0

    # 4) the wine glass alone (BVH path), glass and opaque
    for tag, material in (("mesh", "glass"), ("mesh_opaque", "opaque")):
        eng_m = _mesh_engine(width, height, material)
        best_s, rays = bench_cfg(tag, eng_m, eng_m._cfg)
        result[f"{tag}_mrays"] = rays / best_s / 1e6
        result[f"{tag}_frame_ms"] = best_s * 1000.0

    # 4b) a ~200k-triangle mesh
    big = _big_mesh_engine(width, height)
    best_s, rays = bench_cfg("big_mesh", big, big._cfg)
    result["big_mesh_tris"] = int(big._flat.mesh.num_tris)
    result["big_mesh_mrays"] = rays / best_s / 1e6
    result["big_mesh_frame_ms"] = best_s * 1000.0

    result["compile_s"] = compile_s
    return result


def main():
    import jax

    from raytracevs_tpu.runtime.cache import enable_compilation_cache

    if jax.devices()[0].platform != "gpu":
        print(f"error: no GPU (platform {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 1
    enable_compilation_cache()
    print(json.dumps(run(int(os.environ.get("BENCH_WIDTH", 1920)),
                         int(os.environ.get("BENCH_HEIGHT", 1080)),
                         int(os.environ.get("BENCH_FRAMES", 3)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
