"""End-to-end render tests: engine invariants on small frames."""
import os

import numpy as np
import pytest

from raytracevs_tpu import Engine
from raytracevs_tpu.scene.data import (
    LightData, LightType, MaterialData, PlaneData, SceneData, SphereData,
)


def _simple_scene(spp=1, bounces=3, **settings):
    scene = SceneData()
    scene.objects.append(
        SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0,
                   material=MaterialData())
    )
    scene.objects.append(PlaneData(position=np.zeros(3), normal=np.array([0.0, 1.0, 0.0])))
    scene.lights.append(
        LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                  intensity=5.0)
    )
    scene.camera.position = np.array([0.0, 2.0, -5.0])
    scene.camera.look_at = np.array([0.0, 1.0, 0.0])
    scene.settings.samples_per_pixel = spp
    scene.settings.max_bounces = bounces
    for k, v in settings.items():
        setattr(scene.settings, k, v)
    return scene


@pytest.fixture(scope="module")
def small_frame():
    eng = Engine(64, 64)
    eng.update_scene(_simple_scene())
    img = eng.render()
    return eng, img


def test_render_shape_dtype(small_frame):
    _, img = small_frame
    assert img.shape == (64, 64, 4)
    assert img.dtype == np.uint8
    assert np.all(img[..., 3] == 255)


def test_sky_on_top_sphere_in_middle(small_frame):
    _, img = small_frame
    top = img[2, 32, :3].astype(float)
    # Sky gradient: blue channel dominant
    assert top[2] > top[0]
    # Center of frame hits the sphere (gray-ish diffuse, not sky blue)
    mid = img[30, 32, :3].astype(float)
    assert mid[2] - mid[0] < 20


def test_shadow_under_sphere(small_frame):
    _, img = small_frame
    # The point light at (3,5,-3) casts the sphere shadow onto the floor
    # left of the sphere; floor pixels in shadow are darker than lit floor.
    floor = img[52:62, :, :3].astype(float).mean(axis=-1)
    assert floor.min() < floor.max() * 0.7


def test_rays_counted(small_frame):
    eng, _ = small_frame
    assert eng.last_rays > 64 * 64  # at least primary + shadows


def test_pixel_data_roundtrip(small_frame):
    eng, img = small_frame
    data = eng.get_pixel_data()
    assert len(data) == 64 * 64 * 4
    assert np.frombuffer(data, np.uint8).reshape(64, 64, 4).tobytes() == img.tobytes()


def test_determinism():
    eng1 = Engine(32, 32)
    eng1.update_scene(_simple_scene())
    img1 = eng1.render()
    eng2 = Engine(32, 32)
    eng2.update_scene(_simple_scene())
    img2 = eng2.render()
    np.testing.assert_array_equal(img1, img2)


def test_empty_scene_renders_sky():
    eng = Engine(32, 32)
    eng.update_scene(SceneData())
    img = eng.render()
    # all sky: blue dominant everywhere above horizon
    top = img[:10, :, :3].astype(float)
    assert (top[..., 2] > top[..., 0]).mean() > 0.9


def test_emissive_material_glows():
    scene = SceneData()
    m = MaterialData(emission=np.array([5.0, 0.0, 0.0, 0.0]))
    scene.objects.append(SphereData(position=np.array([0.0, 0.0, 3.0]), radius=1.0, material=m))
    scene.camera.position = np.array([0.0, 0.0, -3.0])
    scene.camera.look_at = np.array([0.0, 0.0, 0.0])
    scene.settings.samples_per_pixel = 1
    scene.settings.tone_map_operator = 2
    eng = Engine(32, 32)
    eng.update_scene(scene)
    img = eng.render()
    center = img[16, 16, :3].astype(float)
    assert center[0] == 255  # saturated red emission


def test_metal_reflects_sky():
    scene = _simple_scene()
    scene.objects[0].material = MaterialData(metallic=1.0, roughness=0.0)
    eng = Engine(48, 48)
    eng.update_scene(scene)
    img = eng.render()
    # Upper part of the metal sphere mirrors the sky: blue-ish
    mid = img[18, 24, :3].astype(float)
    assert mid[2] > mid[0]


def test_glass_transmission_shows_background():
    scene = SceneData()
    glass = MaterialData(transmission=1.0, ior=1.05, roughness=0.0,
                         base_color=np.array([1.0, 1.0, 1.0, 1.0]))
    scene.objects.append(SphereData(position=np.array([0.0, 0.0, 2.0]), radius=1.0,
                                    material=glass))
    scene.lights.append(LightData(type=LightType.AMBIENT, intensity=1.0))
    scene.camera.position = np.array([0.0, 0.0, -3.0])
    scene.camera.look_at = np.array([0.0, 0.0, 0.0])
    scene.settings.samples_per_pixel = 1
    scene.settings.max_bounces = 8
    eng = Engine(32, 32)
    eng.update_scene(scene)
    img = eng.render()
    center = img[16, 16, :3].astype(float)
    assert center.sum() > 60  # sees refracted sky, not black


def test_exposure_and_tonemap_settings_apply():
    bright = _simple_scene(exposure=4.0)
    dark = _simple_scene(exposure=0.25)
    e1 = Engine(32, 32)
    e1.update_scene(bright)
    i1 = e1.render()
    e2 = Engine(32, 32)
    e2.update_scene(dark)
    i2 = e2.render()
    assert i1[..., :3].astype(float).mean() > i2[..., :3].astype(float).mean()


def test_scene_checksum_temporal_reset_semantics():
    """History reset mirrors DXRPipeline.cpp:2795-2880: object geometry
    changes reset the denoiser history; camera moves do NOT (motion vectors
    carry history); the RNG frame index is monotonic and never resets
    (DXRPipeline.cpp:779-780)."""
    eng = Engine(32, 32)
    eng.update_scene(_simple_scene(enable_denoiser=True))
    eng.render()
    eng.render()
    assert eng._frame_index == 2
    assert eng._denoise_state is not None

    # camera-only change: history survives, frame index keeps counting
    s_cam = _simple_scene(enable_denoiser=True)
    s_cam.camera.position = np.array([0.5, 2.0, -5.0])
    eng.update_scene(s_cam)
    assert eng._denoise_state is not None
    assert eng._frame_index == 2
    eng.render()
    assert eng._frame_index == 3

    # object geometry change: history resets, frame index still monotonic
    s2 = _simple_scene(enable_denoiser=True)
    s2.objects[0].radius = 0.5
    eng.update_scene(s2)
    assert eng._denoise_state is None
    assert eng._frame_index == 3

    # material-only change: like the reference, NOT part of the reset key
    s3 = _simple_scene(enable_denoiser=True)
    s3.objects[0].radius = 0.5  # same geometry as s2
    s3.objects[0].material = MaterialData(metallic=1.0)
    eng.render()
    eng.update_scene(s3)
    assert eng._denoise_state is not None


def test_sample_scene_renders(analytic_scene_path):
    eng = Engine(64, 64)
    # Keep it cheap: cap spp via config override (analytic subset; the
    # full mesh-bearing scene renders through the CLI e2e test)
    eng.load_rtvs(analytic_scene_path, samples_per_pixel=2)
    img = eng.render()
    assert img.shape == (64, 64, 4)
    rgb = img[..., :3].astype(float)
    assert 40 < rgb.mean() < 240  # neither black nor blown out
    assert rgb.std() > 20  # has structure


def test_photon_debug_replace():
    """PhotonDebugMode > 0 with caustics replaces the primary contribution
    with caustic * PhotonDebugScale and clears specular + SIGMA shadow
    (RayGen.hlsl:505-518)."""
    import jax.numpy as jnp

    from raytracevs_tpu.ops.render import render_rows
    from raytracevs_tpu.scene.flatten import flatten_scene, make_config

    scene = _simple_scene(enable_caustics=True)
    glass = MaterialData(transmission=0.9, ior=1.5)
    scene.objects[0] = SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.8,
                                  material=glass)
    scene.settings.photon_debug_mode = 5
    scene.settings.photon_debug_scale = 2.0
    flat = flatten_scene(scene, aspect=1.0)
    cfg = make_config(scene, 48, 48)
    assert cfg.num_photons > 0
    out = render_rows(flat, cfg, jnp.int32(0), 48)

    oid = np.asarray(out.gbuffer.obj_id)
    # plane lanes (type 1) are diffuse -> replaced
    plane_lanes = oid == 1 * 65536
    assert plane_lanes.any()
    spec = np.asarray(out.gbuffer.specular_hitdist)[:, :3]
    assert np.abs(spec[plane_lanes]).max() == 0.0
    sdata = np.asarray(out.gbuffer.shadow_data)
    assert np.all(sdata[plane_lanes, 1] == 1.0)  # visibility cleared to lit

    # the debug view replaces color: scale=2 frame == 2 * scale=1 frame at
    # replaced lanes (pure caustic, linear in PhotonDebugScale)
    scene.settings.photon_debug_scale = 1.0
    cfg1 = make_config(scene, 48, 48)
    flat1 = flatten_scene(scene, aspect=1.0)
    out1 = render_rows(flat1, cfg1, jnp.int32(0), 48)
    c2 = np.asarray(out.color)[plane_lanes]
    c1 = np.asarray(out1.color)[plane_lanes]
    np.testing.assert_allclose(c2, 2.0 * c1, atol=1e-5)


def test_copy_pixels_into_failure_fills(small_frame):
    """NativeBridge.cpp:266-356 color-coded readback sentinels."""
    eng, img = small_frame
    needed = eng.width * eng.height * 4

    buf = bytearray(needed)
    assert eng.copy_pixels_into(buf) is True
    assert bytes(buf) == eng.get_pixel_data()

    small = bytearray(needed // 2)
    assert eng.copy_pixels_into(small) is False
    assert small[0:4] == bytes([255, 255, 0, 255])  # yellow: too small

    fresh = Engine(8, 8)
    buf8 = bytearray(8 * 8 * 4)
    assert fresh.copy_pixels_into(buf8) is False
    assert buf8[0:4] == bytes([0, 255, 0, 255])  # green: nothing rendered

    zero = Engine(0, 0)
    z = bytearray(16)
    assert zero.copy_pixels_into(z) is False
    assert z[0:4] == bytes([255, 0, 0, 255])  # red: zero-size frame


def test_validate_frame(small_frame):
    """Debug-layer analog: output-contract audit comes back clean."""
    eng, _ = small_frame
    report = eng.validate_frame()
    assert report["ok"], report["violations"]
    assert eng.last_hdr is not None and eng.last_hdr.shape[-1] == 3


def test_render_loop_coalesces_updates():
    """Async loop: rapid scene submissions coalesce latest-wins
    (RenderWindow.xaml.cs:347-451)."""
    import time

    from raytracevs_tpu.runtime.render_loop import RenderLoop

    eng = Engine(32, 32)
    frames = []
    loop = RenderLoop(eng, on_frame=lambda img, ms: frames.append((img, ms)))
    # queue several scenes BEFORE starting: only the newest should render
    for r in (0.5, 0.7, 0.9, 1.1, 1.3):
        scene = _simple_scene()
        scene.objects[0] = SphereData(position=np.array([0.0, 1.0, 0.0]),
                                      radius=r, material=MaterialData())
        loop.submit_scene(scene)
    assert loop.frames_coalesced == 4
    loop.start()
    deadline = time.time() + 120
    while not frames and time.time() < deadline:
        time.sleep(0.1)
    loop.stop()
    assert frames, "no frame rendered"
    img, ms = frames[0]
    assert img.shape == (32, 32, 4) and ms > 0
    # the engine holds the LAST submitted scene (radius 1.3)
    assert eng._scene.objects[0].radius == 1.3


@pytest.mark.nightly
def test_random_scenes_render_finite():
    """Robustness fuzz: random small scenes always produce finite frames
    (the reference's resilience story, SURVEY §4/§5.3)."""
    from raytracevs_tpu.scene.data import BoxData, SceneData

    rng = np.random.RandomState(7)
    for seed in range(4):
        scene = SceneData()
        for _ in range(rng.randint(1, 4)):
            kind = rng.randint(3)
            mat = MaterialData(
                base_color=np.append(rng.rand(3), 1.0),
                metallic=float(rng.rand()), roughness=float(rng.rand()),
                transmission=float(rng.rand() * rng.randint(2)),
                ior=float(1.0 + rng.rand()),
            )
            pos = rng.uniform(-3, 3, 3); pos[1] = abs(pos[1])
            if kind == 0:
                scene.objects.append(SphereData(position=pos,
                                                radius=float(rng.rand() * 2),
                                                material=mat))
            elif kind == 1:
                scene.objects.append(BoxData(center=pos,
                                             size=rng.rand(3) * 2 + 0.1,
                                             material=mat))
            else:
                scene.objects.append(PlaneData())
        for _ in range(rng.randint(0, 3)):
            scene.lights.append(LightData(
                type=LightType(rng.randint(3)),
                position=rng.uniform(-5, 8, 3),
                intensity=float(rng.rand() * 20),
                radius=float(rng.rand() * 0.5),
            ))
        scene.camera.position = np.array([0.0, 2.0, -5.0])
        scene.settings.samples_per_pixel = 1
        scene.settings.max_bounces = 4
        eng = Engine(24, 24)
        eng.update_scene(scene)
        img = eng.render()
        assert np.isfinite(np.asarray(eng.last_hdr)).all(), f"seed {seed}: non-finite HDR"
        assert img.shape == (24, 24, 4)


def test_cache_dir_resolution(monkeypatch):
    """The compile cache lives in JAX_COMPILATION_CACHE_DIR when that is set
    (and the code sets no directory of its own), else in <repo>/.jax_cache."""
    import jax

    from raytracevs_tpu.runtime import cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.resolve_cache_dir() == os.path.join(repo, ".jax_cache")
        assert cache.enable_compilation_cache() == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(repo, ".jax_cache")

        jax.config.update("jax_compilation_cache_dir", before)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert cache.resolve_cache_dir() == "/elsewhere/cache"
        assert cache.enable_compilation_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_debug_views_show_denoised_shadow():
    """Modes 3/4 must show the ShadowDenoise output, not the raw input
    (Composite.hlsl:199-221): with the denoiser on, the engine keeps the
    last frame's denoised diffuse/specular/shadow and the split-screen
    mode 4 has visibly different halves in a soft-shadow scene."""
    scene = _simple_scene(spp=1, bounces=3, enable_denoiser=True)
    # area light -> noisy single-sample soft shadow that the filter smooths
    scene.lights[0] = LightData(
        type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
        intensity=8.0, radius=0.8,
    )
    eng = Engine(64, 64)
    eng.update_scene(scene)
    eng.render()
    assert eng._last_denoised is not None

    raw = eng.render_debug_view(2).astype(np.int32)      # input shadow
    den = eng.render_debug_view(3).astype(np.int32)      # denoised shadow
    split = eng.render_debug_view(4).astype(np.int32)    # input | denoised

    # the shadow filter must actually change the buffer
    assert np.abs(raw - den).max() > 0
    # split screen: left half equals the input view, right half the denoised
    np.testing.assert_array_equal(split[:, :32], raw[:, :32])
    np.testing.assert_array_equal(split[:, 32:], den[:, 32:])
    assert np.abs(split[:, :32] - raw[:, :32]).max() == 0
    assert np.abs(split - raw).max() > 0  # halves differ somewhere


def test_multi_sample_soft_shadows():
    """Lifting the soft-shadow clamp (max_soft_samples override) exercises
    the 1-16 sample contract (Common.hlsli:1199-1357): more samples give a
    smoother penumbra than the reference's clamp-to-1 default
    (DXRPipeline.cpp:928)."""
    def build(n_samples):
        scene = _simple_scene(spp=1, bounces=3)
        scene.lights[0] = LightData(
            type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
            intensity=8.0, radius=1.0, soft_shadow_samples=n_samples,
        )
        return scene

    eng1 = Engine(64, 64)
    eng1.update_scene(build(8))  # default config: unroll bound stays 1
    assert eng1._cfg.max_soft_samples == 1
    img1 = eng1.render()

    eng8 = Engine(64, 64)
    eng8.update_scene(build(8), max_soft_samples=8)
    assert eng8._cfg.max_soft_samples == 8
    img8 = eng8.render()

    assert np.isfinite(img8).all() if img8.dtype.kind == 'f' else True
    diff = np.abs(img1.astype(np.int32) - img8.astype(np.int32))
    assert diff.max() > 0, "8-sample soft shadows must differ from 1-sample"

    # penumbra visibility variance: 8 samples averages the shadow edge ->
    # strictly fewer extreme-value pixels in the shadow's gradient region
    g1 = np.asarray(eng1._last_gbuffer.shadow_data)[:, 1]
    g8 = np.asarray(eng8._last_gbuffer.shadow_data)[:, 1]
    partial1 = ((g1 > 0.01) & (g1 < 0.99)).sum()
    partial8 = ((g8 > 0.01) & (g8 < 0.99)).sum()
    assert partial8 > partial1, (partial8, partial1)
