"""Multi-device sharding tests on the 8-device virtual CPU mesh."""
import numpy as np
import pytest

import jax

from raytracevs_tpu.ops.render import render_frame
from raytracevs_tpu.parallel.tiles import make_mesh, render_frame_sharded
from raytracevs_tpu.scene.data import (
    LightData, LightType, PlaneData, SceneData, SphereData,
)
from raytracevs_tpu.scene.flatten import flatten_scene, make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene


def _scene():
    scene = SceneData()
    scene.objects.append(SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0))
    scene.objects.append(PlaneData())
    scene.lights.append(
        LightData(type=LightType.POINT, position=np.array([3.0, 5.0, -3.0]), intensity=5.0)
    )
    scene.settings.samples_per_pixel = 1
    scene.settings.max_bounces = 3
    return sanitize_scene(scene)


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device():
    scene = _scene()
    flat = flatten_scene(scene)
    cfg = make_config(scene, 32, 32)
    single = render_frame(flat, cfg)
    mesh = make_mesh()
    sharded = render_frame_sharded(flat, cfg, mesh)
    np.testing.assert_allclose(
        np.asarray(sharded.color), np.asarray(single.color), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sharded.gbuffer.view_z), np.asarray(single.gbuffer.view_z), atol=1e-4
    )
    assert float(np.asarray(sharded.rays).sum()) == float(np.asarray(single.rays))


def test_sharded_output_is_actually_sharded():
    scene = _scene()
    flat = flatten_scene(scene)
    cfg = make_config(scene, 32, 32)
    mesh = make_mesh()
    out = render_frame_sharded(flat, cfg, mesh)
    shards = out.color.addressable_shards
    assert len(shards) == 8
    # each device holds a distinct row slab
    assert shards[0].data.shape[0] == 32 * 32 // 8


def test_height_divisibility_guard():
    scene = _scene()
    flat = flatten_scene(scene)
    cfg = make_config(scene, 32, 30)
    with pytest.raises(ValueError):
        render_frame_sharded(flat, cfg, make_mesh())


def test_sharded_full_pipeline_matches_single_device():
    """Engine-level multi-device: render + DENOISE (halo-row ppermute
    collectives) + composite under shard_map equals the single-device
    pipeline bit-for-bit, across two frames so real reprojection history
    flows through the temporal halo exchange."""
    from raytracevs_tpu.parallel.tiles import render_pipeline_sharded
    from raytracevs_tpu.post import denoise as denoise_mod
    from raytracevs_tpu.runtime.engine import _render_pipeline

    scene = _scene()
    scene.settings.enable_denoiser = True
    W, H = 64, 64  # 8 rows/shard: spatial halo(8) == slab, temporal multi-hop
    flat = flatten_scene(scene, aspect=W / H)
    cfg = make_config(scene, W, H)
    mesh = make_mesh()

    state_single = denoise_mod.init_state(H, W)
    state_shard = denoise_mod.init_state(H, W)
    for frame in range(2):
        f = flat._replace(frame_index=np.uint32(frame))
        rgba_s, hdr_s, _rays, _g, state_single, den_s = _render_pipeline(
            f, cfg, state_single)
        rgba_m, hdr_m, rays_m, _gm, state_shard, den_m = render_pipeline_sharded(
            f, cfg, mesh, state_shard)
        # denoised diffuse carries ~1-ULP XLA fusion-order noise between
        # the two program shapes; everything else is exact
        np.testing.assert_allclose(
            np.asarray(rgba_m).reshape(H, W, 4).astype(np.int32),
            np.asarray(rgba_s).astype(np.int32), atol=1)
        np.testing.assert_allclose(np.asarray(den_m[0]),
                                   np.asarray(den_s[0]), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(den_m[2]),
                                      np.asarray(den_s[2]))
        for a, b in zip(jax.tree_util.tree_leaves(state_shard),
                        jax.tree_util.tree_leaves(state_single)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert len(rgba_m.addressable_shards) == 8


def test_sharded_pipeline_want_aux_false_matches_and_skips_aux():
    """want_aux=False (streaming/bench contract) must return the identical
    image + rays with None hdr/gbuffer/denoised slots."""
    from raytracevs_tpu.parallel.tiles import render_pipeline_sharded
    from raytracevs_tpu.post import denoise as denoise_mod

    scene = _scene()
    scene.settings.enable_denoiser = True
    W, H = 64, 64
    flat = flatten_scene(scene, aspect=W / H)
    cfg = make_config(scene, W, H)
    mesh = make_mesh()

    st_a = denoise_mod.init_state(H, W)
    st_b = denoise_mod.init_state(H, W)
    rgba_a, hdr_a, rays_a, gb_a, st_a, den_a = render_pipeline_sharded(
        flat, cfg, mesh, st_a)
    rgba_b, hdr_b, rays_b, gb_b, st_b, den_b = render_pipeline_sharded(
        flat, cfg, mesh, st_b, want_aux=False)
    assert hdr_b is None and gb_b is None and den_b is None
    assert hdr_a is not None and gb_a is not None and den_a is not None
    np.testing.assert_array_equal(np.asarray(rgba_b), np.asarray(rgba_a))
    assert float(np.asarray(rays_b).sum()) == float(np.asarray(rays_a).sum())
    for a, b in zip(jax.tree_util.tree_leaves(st_a),
                    jax.tree_util.tree_leaves(st_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
