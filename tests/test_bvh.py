"""BVH build + traversal tests (native SAH and numpy fallback)."""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from raytracevs_tpu.io.fbx import load_fbx
from raytracevs_tpu.io.mesh_cache import wine_glass_mesh
from raytracevs_tpu.ops import bvh


ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets")


def _tri_soup(vertices, normals, indices):
    tris = indices.reshape(-1, 3)
    return (
        vertices[tris[:, 0]], vertices[tris[:, 1]], vertices[tris[:, 2]],
        normals[tris[:, 0]], normals[tris[:, 1]], normals[tris[:, 2]],
        np.zeros(len(tris), np.int32),
    )


@pytest.fixture(scope="module")
def glass_tris():
    """The canonical scene's wine glass (generated in code, 5,888 tris),
    stood up along +Y at a tenth of its size: 1.005 units tall, like the
    reference's WineGlass.fbx."""
    m = wine_glass_mesh()
    v = np.asarray(m.vertices).reshape(-1, 8)

    def stand(a):  # +90 degrees about X: (x, y, z) -> (x, -z, y)
        return np.stack([a[:, 0], -a[:, 2], a[:, 1]], axis=1)

    return _tri_soup(stand(v[:, 0:3]) * np.float32(0.1), stand(v[:, 4:7]),
                     np.asarray(m.indices).astype(np.int64))


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    o = jnp.asarray(np.array([[0, 0.5, -3.0]] * n) + rng.randn(n, 3) * 0.2, jnp.float32)
    d = jnp.asarray(rng.randn(n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_fbx_import_sane():
    """Needs the reference's WineGlass.fbx, which does not ship here: put
    it in assets/ to run this test."""
    m = load_fbx(os.path.join(ASSETS, "WineGlass.fbx"))
    tris = _tri_soup(m.vertices, m.normals, m.indices)
    assert len(tris[0]) == 5904
    np.testing.assert_allclose(np.linalg.norm(tris[3], axis=1), 1.0, atol=1e-4)


def test_native_matches_python_builder(glass_tris):
    b_native = bvh.build_bvh(*glass_tris, use_native=True)
    b_python = bvh.build_bvh(*glass_tris, use_native=False)
    mesh_n = bvh.to_device(b_native, np.array([1.0]), np.array([[0.0, 0, 0]]))
    mesh_p = bvh.to_device(b_python, np.array([1.0]), np.array([[0.0, 0, 0]]))
    o, d = _rays(128)
    tmin = jnp.full((128,), 0.001, jnp.float32)
    tmax = jnp.full((128,), 1e4, jnp.float32)
    h1 = bvh.traverse_closest(mesh_n, o, d, tmin, tmax)
    h2 = bvh.traverse_closest(mesh_p, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(h1.hit), np.asarray(h2.hit))
    m = np.asarray(h1.hit)
    np.testing.assert_allclose(np.asarray(h1.t)[m], np.asarray(h2.t)[m], atol=1e-5)


def test_traversal_matches_bruteforce(glass_tris):
    b = bvh.build_bvh(*glass_tris)
    mesh = bvh.to_device(b, np.array([1.0]), np.array([[0.0, 0, 0]]))
    o, d = _rays(32, seed=7)
    tmin = jnp.full((32,), 0.001, jnp.float32)
    tmax = jnp.full((32,), 1e4, jnp.float32)
    hit = bvh.traverse_closest(mesh, o, d, tmin, tmax)
    on = np.asarray(o)
    dn = np.asarray(d)
    for i in range(32):
        pv = np.cross(dn[i], b.edge2)
        det = (b.edge1 * pv).sum(1)
        ok = np.abs(det) > 1e-9
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = on[i] - b.v0
        u = (tv * pv).sum(1) * inv
        qv = np.cross(tv, b.edge1)
        v = (dn[i] * qv).sum(1) * inv
        t = (b.edge2 * qv).sum(1) * inv
        mask = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0.001)
        ref_t = t[mask].min() if mask.any() else np.inf
        got_t = float(hit.t[i]) if bool(hit.hit[i]) else np.inf
        if np.isinf(ref_t):
            assert np.isinf(got_t)
        else:
            assert got_t == pytest.approx(ref_t, rel=1e-5)


def test_shadow_translucency_counts_crossings(glass_tris):
    # instance transmission 0.5: visibility = 0.5^crossings
    b = bvh.build_bvh(*glass_tris)
    mesh = bvh.to_device(b, np.array([0.5]), np.array([[0.0, 0.0, 0.0]]))
    n = 8
    o = jnp.asarray([[0.0, 0.5, -3.0]] * n, jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]] * n, jnp.float32)
    vis, color, occ = bvh.traverse_shadow(mesh, o, d, jnp.full((n,), 100.0))
    v = float(vis[0])
    # the ray crosses the glass wall multiple times -> 0 < vis < 1
    assert 0.0 < v < 1.0
    k = round(np.log(v) / np.log(0.5))
    assert v == pytest.approx(0.5 ** k, rel=1e-4)


def test_native_fnv1a_known_value():
    from raytracevs_tpu.io.native import fnv1a

    h = fnv1a(b"hello")
    if h is None:
        pytest.skip("native library unavailable")
    assert h == 0xA430D84680AABD0B


class _FakeMesh:
    def __init__(self, positions, normals, indices):
        self.positions = positions
        self.normals = normals
        self.indices = indices


def _quad_mesh():
    # unit square in the XZ plane at y=0, facing +Y
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]], np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return _FakeMesh(pos, nrm, idx)


def test_blas_cache_skips_sah_on_transform_edit():
    """Transform edits must not re-run the SAH builder: the BLAS is cached
    by mesh name (AccelerationStructure.cpp:560-663) and instances only
    retransform (:665-848)."""
    from raytracevs_tpu.scene.data import (
        LightData, LightType, MaterialData, MeshObjectData, SceneData,
    )
    from raytracevs_tpu.scene.flatten import flatten_scene
    from raytracevs_tpu.scene.transform import Transform, euler_deg_to_quat

    mesh = _quad_mesh()

    class _Svc:
        def get_mesh(self, name):
            return mesh if name == "Quad" else None

    def scene_with(transform):
        s = SceneData()
        s.objects.append(MeshObjectData(mesh_name="Quad", transform=transform,
                                        material=MaterialData()))
        s.lights.append(LightData(type=LightType.POINT,
                                  position=np.array([0.0, 5.0, 0.0]), intensity=5.0))
        return s

    cache = bvh.BLASCache()
    flatten_scene(scene_with(Transform()), mesh_service=_Svc(), blas_cache=cache)
    assert cache.build_count == 1
    moved = Transform(position=np.array([2.0, 0.5, 1.0]),
                      rotation=euler_deg_to_quat([0, 45, 0]),
                      scale=np.array([2.0, 1.0, 1.0]))
    flat = flatten_scene(scene_with(moved), mesh_service=_Svc(), blas_cache=cache)
    assert cache.build_count == 1  # no SAH rebuild on transform edit
    # the transformed BVH still bounds the transformed geometry
    v0 = np.asarray(flat.mesh.v0)
    lo = np.asarray(flat.mesh.bbox_min)[0]
    hi = np.asarray(flat.mesh.bbox_max)[0]
    assert (v0 >= lo - 1e-4).all() and (v0 <= hi + 1e-4).all()


def test_blas_cache_rebuilds_on_content_change():
    """Same mesh NAME, different geometry -> the cache must rebuild, not
    serve the stale BLAS (content fingerprint, not name-only keying)."""
    mesh_a = _quad_mesh()
    pos_b = mesh_a.positions.copy()
    pos_b[:, 0] *= 3.0  # stretched quad under the same name
    mesh_b = _FakeMesh(pos_b, mesh_a.normals, mesh_a.indices)

    cache = bvh.BLASCache()
    blas_a = cache.get("Quad", mesh_a)
    assert cache.build_count == 1
    assert cache.get("Quad", mesh_a) is blas_a  # unchanged content: cache hit
    assert cache.build_count == 1
    blas_b = cache.get("Quad", mesh_b)
    assert cache.build_count == 2  # content changed: rebuilt
    assert float(blas_b.bbox_max[0][0]) > float(blas_a.bbox_max[0][0]) + 1.0


def test_multi_instance_forest_traversal():
    """Two instances of the same mesh chain into one traversable forest and
    both are hit at their transformed locations."""
    mesh = _quad_mesh()
    cache = bvh.BLASCache()
    blas = cache.get("Quad", mesh)
    assert cache.build_count == 1
    cache.get("Quad", mesh)
    assert cache.build_count == 1  # cached by name

    from raytracevs_tpu.scene.transform import Transform

    t0 = Transform()  # at origin
    t1 = Transform(position=np.array([5.0, 0.0, 0.0]))
    combined = bvh.combine_blas([
        bvh.transform_blas(blas, t0.matrix(), 0),
        bvh.transform_blas(blas, t1.matrix(), 1),
    ])
    dev = bvh.to_device(combined, np.zeros(2, np.float32), np.zeros((2, 3), np.float32))

    o = jnp.asarray(np.array([[0.5, 1.0, 0.5], [5.5, 1.0, 0.5]], np.float32))
    d = jnp.asarray(np.tile(np.array([0, -1, 0], np.float32), (2, 1)))
    hit = bvh.traverse_closest(dev, o, d, 1e-3, 100.0)
    assert np.asarray(hit.hit).all()
    np.testing.assert_allclose(np.asarray(hit.t), [1.0, 1.0], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(hit.inst), [0, 1])

    # a ray missing both instances walks the whole chain and reports no hit
    o2 = jnp.asarray(np.array([[2.5, 1.0, 5.5]], np.float32))
    d2 = jnp.asarray(np.array([[0, -1, 0]], np.float32))
    hit2 = bvh.traverse_closest(dev, o2, d2, 1e-3, 100.0)
    assert not np.asarray(hit2.hit).any()
