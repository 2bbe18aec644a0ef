"""Photon-axis multi-device parallelism (SURVEY §2.5 photon row).

The photon batch is embarrassingly parallel: every per-photon seed
(emission AND the Russian-roulette chain) is keyed on the photon's GLOBAL
index, so per-device slices compose bit-exactly into the full batch. The
sharded pipeline traces total/n_dev photons per device and all_gathers the
store arrays (parallel/tiles.py::_sharded_photon_map).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracevs_tpu.ops import photon as photon_mod
from raytracevs_tpu.scene.data import (
    LightData, LightType, MaterialData, PlaneData, SceneData, SphereData,
)
from raytracevs_tpu.scene.flatten import flatten_scene, make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene


def _caustic_scene():
    scene = SceneData()
    glass = MaterialData(transmission=0.9, ior=1.5, roughness=0.0)
    scene.objects.append(SphereData(position=np.array([0.0, 1.2, 0.0]),
                                    radius=0.8, material=glass))
    scene.objects.append(PlaneData())
    scene.lights.append(
        LightData(type=LightType.POINT, position=np.array([0.0, 2.8, 0.0]),
                  intensity=20.0))
    scene.settings.samples_per_pixel = 1
    scene.settings.max_bounces = 3
    scene.settings.enable_caustics = True
    return sanitize_scene(scene)


def test_photon_slices_compose_bit_exactly():
    """trace_photon_slice over k slices == the full-batch trace, element
    for element (global-index seeding; PhotonEmit.hlsl:44-48 parity)."""
    flat = flatten_scene(_caustic_scene())
    n = 2048
    full = photon_mod.trace_photon_slice(flat, n, 0, n)
    assert int(np.asarray(full[4]).sum()) > 50  # scene stores caustics

    per = n // 4
    parts = [photon_mod.trace_photon_slice(flat, n, k * per, per)
             for k in range(4)]
    for f in range(5):
        stitched = np.concatenate([np.asarray(p[f]) for p in parts], axis=0)
        np.testing.assert_array_equal(stitched, np.asarray(full[f]),
                                      err_msg=f"store field {f}")

    # and the hash build over the stitched stores equals emit_and_trace
    pm_ref = photon_mod.emit_and_trace(flat, n)
    pm_st = photon_mod.build_photon_hash(
        *[jnp.asarray(np.concatenate([np.asarray(p[f]) for p in parts]))
          for f in range(5)])
    for a, b in zip(jax.tree_util.tree_leaves(pm_st),
                    jax.tree_util.tree_leaves(pm_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_emit_slice_matches_full_rows():
    """_emit_photons(offset, count) returns exactly those rows of the full
    emission (directional + point mix)."""
    scene = _caustic_scene()
    scene.lights.append(
        LightData(type=LightType.DIRECTIONAL,
                  position=np.array([2.0, 5.0, -1.0]), intensity=3.0))
    flat = flatten_scene(sanitize_scene(scene))
    n = 1024
    full = photon_mod._emit_photons(flat, n)
    part = photon_mod._emit_photons(flat, n, offset=256, count=512)
    for f, p in zip(full, part):
        np.testing.assert_array_equal(np.asarray(f)[256:768], np.asarray(p))


@pytest.mark.nightly
def test_sharded_photon_map_is_bit_identical():
    """_sharded_photon_map under shard_map (slice trace + all_gather +
    replicated hash build) equals the single-device PhotonMap bit for
    bit — the strong guarantee behind the sharded caustics path."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from raytracevs_tpu.parallel.tiles import (
        _sharded_photon_map, make_mesh,
    )

    scene = _caustic_scene()
    W, H = 32, 32
    flat = flatten_scene(scene, aspect=W / H)
    cfg = make_config(scene, W, H, num_photons=2048)
    mesh = make_mesh()  # 8 devices -> 256 photons per device

    pm_ref = photon_mod.emit_and_trace(flat, 2048)
    specs_in = jax.tree_util.tree_map(lambda _: P(), flat)
    pm_specs = jax.tree_util.tree_map(lambda _: P(), pm_ref)
    pm = shard_map(
        lambda s: _sharded_photon_map(s, cfg, 8),
        mesh=mesh, in_specs=(specs_in,), out_specs=pm_specs,
        check_vma=False,
    )(flat)
    assert int(np.asarray(pm.count)) > 50
    for name, a, b in zip(pm._fields, pm, pm_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_sharded_pipeline_caustics_matches_single_device():
    """The full sharded pipeline with caustics ON renders the same frame
    as the single-device pipeline. The photon MAP is bit-identical (test
    above); the frame comparison tolerates a small fraction of caustic
    pixels where ~1-ULP XLA fusion noise in the primary-hit positions
    (different program shapes) flips a photon's discrete
    dist^2 < radius^2 acceptance."""
    from raytracevs_tpu.parallel.tiles import make_mesh, render_pipeline_sharded
    from raytracevs_tpu.runtime.engine import _render_pipeline

    scene = _caustic_scene()
    scene.settings.enable_denoiser = False
    W, H = 32, 32
    flat = flatten_scene(scene, aspect=W / H)
    cfg = make_config(scene, W, H, num_photons=2048)
    assert cfg.num_photons == 2048

    rgba_s, hdr_s, rays_s, _g, _st, _dn = _render_pipeline(flat, cfg, None)
    mesh = make_mesh()  # 8 devices -> 256 photons per device
    rgba_m, hdr_m, rays_m, _gm, _stm, _dnm = render_pipeline_sharded(
        flat, cfg, mesh, None)
    rgba_d = np.abs(np.asarray(rgba_m).astype(np.int32)
                    - np.asarray(rgba_s).reshape(H, W, 4).astype(np.int32))
    assert (rgba_d.max(axis=-1) > 2).mean() < 0.02
    hdr_d = np.abs(np.asarray(hdr_m)
                   - np.asarray(hdr_s).reshape(H, W, 3)).max(axis=-1)
    assert (hdr_d > 1e-4).mean() < 0.02
    assert float(np.asarray(rays_m).sum()) == float(np.asarray(rays_s))
    # the caustic actually contributes (photon pass not compiled out)
    base_cfg = make_config(scene, W, H)
    rgba_off, *_ = _render_pipeline(flat, base_cfg, None)
    assert np.abs(np.asarray(rgba_off).astype(np.int32)
                  - np.asarray(rgba_s).astype(np.int32)).sum() > 0
