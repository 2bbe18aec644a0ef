"""Scene-file tests: sample scene parsing, round trip, evaluation results."""
import os

import numpy as np
import pytest

from raytracevs_tpu.scene.data import LightType, SceneData
from raytracevs_tpu.scene.evaluator import evaluate_scene
from raytracevs_tpu.scene.rtvs import load_graph, save_graph


def test_load_sample_scene(sample_scene_path):
    g = load_graph(sample_scene_path)
    assert len(g.nodes) == 32
    assert len(g.connections) == 31


def test_evaluate_sample_scene(sample_scene_path):
    scene = evaluate_scene(load_graph(sample_scene_path))
    assert isinstance(scene, SceneData)
    assert len(scene.spheres) == 2
    assert len(scene.planes) == 1
    assert len(scene.boxes) == 1
    assert len(scene.mesh_instances) == 1  # WineGlass2 on Object5
    wg = scene.mesh_instances[0]
    np.testing.assert_allclose(wg.transform.position, [0.5, -0.03, -1.5])
    np.testing.assert_allclose(wg.transform.scale, [0.3, 0.3, 0.3])
    np.testing.assert_allclose(wg.transform.rotation,
                               [np.sqrt(0.5), 0.0, 0.0, np.sqrt(0.5)], atol=1e-6)
    assert len(scene.lights) == 3

    # Light parameters wired through math nodes
    ambient = [l for l in scene.lights if l.type == LightType.AMBIENT][0]
    assert ambient.intensity == pytest.approx(0.3)
    point = [l for l in scene.lights if l.type == LightType.POINT][0]
    assert point.intensity == pytest.approx(18.0)
    assert point.radius == pytest.approx(0.1)
    np.testing.assert_allclose(point.position, [0, 4, -1])
    directional = [l for l in scene.lights if l.type == LightType.DIRECTIONAL][0]
    np.testing.assert_allclose(
        directional.direction, np.array([0.5, -1.0, 0.3]) / np.linalg.norm([0.5, -1.0, 0.3])
    )

    # Camera wired through Vector3 nodes
    np.testing.assert_allclose(scene.camera.position, [0, 2.5, -5])
    np.testing.assert_allclose(scene.camera.look_at, [0, 1, 0])
    assert scene.camera.field_of_view == 60.0

    # Render settings from the SceneNode
    s = scene.settings
    assert s.samples_per_pixel == 16
    assert s.max_bounces == 10
    assert s.tone_map_operator == 2
    assert s.gamma == 1.0
    assert s.enable_denoiser is True

    # Glass sphere: radius 0.7, transmission 0.8, absorption (0, 0.8, 0.8)
    glass = [sp for sp in scene.spheres if sp.radius == pytest.approx(0.7)][0]
    assert glass.material.transmission == pytest.approx(0.8)
    np.testing.assert_allclose(glass.material.absorption, [0, 0.8, 0.8])
    assert glass.material.ior == pytest.approx(1.5)

    # Metal sphere: radius 0.8 via Float node, metallic 1, roughness 0
    metal = [sp for sp in scene.spheres if sp.radius == pytest.approx(0.8)][0]
    assert metal.material.metallic == pytest.approx(1.0)
    assert metal.material.roughness == pytest.approx(0.0)
    np.testing.assert_allclose(metal.position, [-2, 1, 0])

    # Box: position (2,1,0); a Vector3(1,1,1) wired into Size overrides the
    # stored (1,2,1) -> half extents (0.5,0.5,0.5)
    box = scene.boxes[0]
    np.testing.assert_allclose(box.center, [2, 1, 0])
    np.testing.assert_allclose(box.size, [0.5, 0.5, 0.5])
    assert box.material.transmission == pytest.approx(0.8)


def test_roundtrip(tmp_path, sample_scene_path):
    g = load_graph(sample_scene_path)
    out = str(tmp_path / "roundtrip.rtvs")
    save_graph(g, out)
    g2 = load_graph(out)
    assert len(g2.nodes) == len(g.nodes)
    assert len(g2.connections) == len(g.connections)
    s1 = evaluate_scene(g)
    s2 = evaluate_scene(g2)
    assert len(s1.objects) == len(s2.objects)
    for a, b in zip(s1.spheres, s2.spheres):
        np.testing.assert_allclose(a.position, b.position)
        assert a.radius == pytest.approx(b.radius)
        np.testing.assert_allclose(a.material.base_color, b.material.base_color)
    np.testing.assert_allclose(s1.camera.position, s2.camera.position)
    assert s1.settings.samples_per_pixel == s2.settings.samples_per_pixel


def test_legacy_lightnode_maps_to_pointlight():
    doc = {
        "Version": "1.0",
        "Nodes": [
            {"Id": "00000000-0000-0000-0000-000000000001", "Type": "LightNode",
             "Title": "L", "PositionX": 0, "PositionY": 0,
             "Properties": {"LightPosition": {"X": 1, "Y": 2, "Z": 3}, "Intensity": 2.0}},
        ],
        "Connections": [],
    }
    g = load_graph(doc)
    scene = evaluate_scene(g)
    assert len(scene.lights) == 1
    assert scene.lights[0].type == LightType.POINT
    np.testing.assert_allclose(scene.lights[0].position, [1, 2, 3])


def test_fallback_path_without_scene_node():
    doc = {
        "Version": "1.0",
        "Nodes": [
            {"Id": "00000000-0000-0000-0000-000000000001", "Type": "SphereNode",
             "Title": "S", "PositionX": 0, "PositionY": 0, "Properties": {"Radius": 2.0}},
            {"Id": "00000000-0000-0000-0000-000000000002", "Type": "CameraNode",
             "Title": "C", "PositionX": 0, "PositionY": 0,
             "Properties": {"CameraPosition": {"X": 0, "Y": 0, "Z": -9}}},
        ],
        "Connections": [],
    }
    scene = evaluate_scene(load_graph(doc))
    assert len(scene.spheres) == 1
    assert scene.spheres[0].radius == 2.0
    np.testing.assert_allclose(scene.camera.position, [0, 0, -9])


def test_trace_recursion_depth_carried_but_dormant(sample_scene_path):
    """trace_recursion_depth round-trips but never changes rendering —
    bit-for-bit the reference's observable behavior: the scene value is
    marshalled to the engine yet UpdateSceneData hard-codes
    maxTraceRecursionDepth = 1 every frame (DXRPipeline.cpp:770), so the
    RTPSO config (:2179) never sees it (docs/PARITY.md dormant table)."""
    from raytracevs_tpu.scene.evaluator import evaluate_scene
    from raytracevs_tpu.scene.flatten import make_config

    scene = evaluate_scene(load_graph(sample_scene_path))
    base = make_config(scene, 64, 64)
    scene.settings.trace_recursion_depth = 31
    assert make_config(scene, 64, 64) == base  # no rendering effect


def test_default_engine_keeps_canonical_wine_glass(sample_scene_path):
    """Missing-mesh regression guard: a DEFAULT-constructed Engine (no
    mesh_service argument — the bench/CLI/viewer path) must render
    sample_scene.rtvs WITH its wine glass: "WineGlass2" is generated in
    code (io/mesh_cache.BUILTIN_MESHES), so no asset file is needed."""
    from raytracevs_tpu.runtime.engine import Engine
    from raytracevs_tpu.scene.data import MeshObjectData

    eng = Engine(32, 32)
    eng.load_rtvs(sample_scene_path, samples_per_pixel=1, max_bounces=2,
                  enable_denoiser=False)
    meshes = [o for o in eng._scene.objects if isinstance(o, MeshObjectData)]
    assert len(meshes) == 1
    assert meshes[0].mesh_name == "WineGlass2"
    assert meshes[0].material.transmission == 1.0  # socket-driven glass BSDF
    assert eng._flat.mesh is not None
    assert int(eng._flat.mesh.num_tris) == 5888
    # the asset stands ~10 units along -Z (pre-transform), 3.66 wide
    rec = eng.mesh_service.get_mesh("WineGlass2")
    assert rec.bounds_min[2] < -9.0
    assert (rec.bounds_max[0] - rec.bounds_min[0]) < 6.0


def test_wine_glass_lathe_matches_profile():
    """The generated glass is the lathe of mesh_cache's profile: outer
    halfwidth follows the table at every height, the bowl is hollow down to
    its floor, the stem is thin, normals are unit and face outward, and the
    mesh is deterministic."""
    from raytracevs_tpu.io import mesh_cache as mc

    mesh = mc.wine_glass_mesh()
    assert len(mesh.indices) // 3 == 2 * 64 * (48 - 2)
    v = np.asarray(mesh.vertices).reshape(-1, 8)
    h = -v[:, 2]
    r = np.hypot(v[:, 0], v[:, 1])
    outer = np.interp(h, mc._GLASS_HEIGHTS, mc._GLASS_RADII)
    assert np.all(r <= outer + 1e-5)
    assert np.isclose(r.max(), max(mc._GLASS_RADII), atol=1e-5)
    assert r[(h > 1.0) & (h < 2.6)].max() < 0.14  # stem
    # hollow bowl: an inner wall one wall thickness inside the outer one
    bowl = (h > 5.0) & (h < 9.5)
    inner = bowl & (r < outer - 0.5 * mc._GLASS_WALL)
    assert inner.sum() >= 64 * 3
    assert np.all(r[inner] > outer[inner] - 1.5 * mc._GLASS_WALL)
    n = v[:, 4:7]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    # outer wall normals point away from the axis at the belly
    sel = (np.abs(h - 5.83) < 0.01) & (r > 1.8)
    assert sel.any() and np.all((v[sel, 0] * n[sel, 0] + v[sel, 1] * n[sel, 1]) > 0)
    again = mc.wine_glass_mesh()
    assert np.array_equal(again.vertices, mesh.vertices)
    assert np.array_equal(again.indices, mesh.indices)
