"""Multi-device rendering: image-row sharding over a device mesh.

The reference's only parallel axis is the pixel grid (DispatchRays(W,H,1),
DXRPipeline.cpp:2932-2937); the multi-device story here is SPMD over image
rows: shard the pixel rows across devices with `shard_map` over a 1-D mesh,
replicate the (small) scene arrays on every device, and let the output stay
sharded. Rays are embarrassingly parallel; the only collectives are the
denoiser's halo-row exchanges and the photon-store all-gather.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.render import FrameOutput, render_rows
from ..scene.flatten import FlatScene, RenderConfig

TILE_AXIS = "tiles"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis name 'tiles'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (TILE_AXIS,))


def _sharded_photon_map(scene_rep, cfg, n_dev: int):
    """Photon-axis parallelism (SURVEY §2.5): each device emits+traces
    total/n_dev photons of the GLOBAL batch (every per-photon seed is
    keyed on the global index, so slices compose bit-exactly —
    ops/photon.py trace_photon_slice), the store arrays all_gather back
    in index order, and the sort-based hash build runs
    replicated. The resulting PhotonMap is identical to the
    single-device one, at 1/n_dev the trace cost per device. Returns None
    (caller's render builds the map replicated) when caustics are off or
    the count doesn't divide evenly."""
    if cfg.num_photons <= 0 or cfg.num_photons % n_dev != 0:
        return None
    from ..ops import photon as photon_mod

    per = cfg.num_photons // n_dev
    i = jax.lax.axis_index(TILE_AXIS)
    stores = photon_mod.trace_photon_slice(
        scene_rep, cfg.num_photons, i * per, per)
    gathered = [jax.lax.all_gather(s, TILE_AXIS, axis=0, tiled=True)
                for s in stores]
    return photon_mod.build_photon_hash(*gathered)


@partial(jax.jit, static_argnums=(1, 2))
def _render_sharded(scene: FlatScene, cfg: RenderConfig, mesh: Mesh) -> FrameOutput:
    n_dev = mesh.devices.size
    rows_per = cfg.height // n_dev

    def shard_fn(scene_rep):
        i = jax.lax.axis_index(TILE_AXIS)
        out = render_rows(scene_rep, cfg, i * rows_per, rows_per,
                          pmap=_sharded_photon_map(scene_rep, cfg, n_dev))
        # scalar ray count -> [1] so it can carry a sharded axis
        return out._replace(rays=out.rays.reshape(1))

    specs_in = jax.tree_util.tree_map(lambda _: P(), scene)
    out = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(specs_in,),
        out_specs=FrameOutput(
            color=P(TILE_AXIS),
            gbuffer=_gbuffer_spec(),
            rays=P(TILE_AXIS),
            raw_specular=P(TILE_AXIS),
        ),
        # Loop carries mix device-invariant scene constants with per-tile
        # varying state; skip the static varying-axes check (values are
        # correct — each shard computes its own rows independently).
        check_vma=False,
    )(scene)
    return out


def _gbuffer_spec():
    from ..ops.render import GBuffer

    return GBuffer(
        diffuse_hitdist=P(TILE_AXIS),
        specular_hitdist=P(TILE_AXIS),
        normal_roughness=P(TILE_AXIS),
        view_z=P(TILE_AXIS),
        motion=P(TILE_AXIS),
        albedo=P(TILE_AXIS),
        shadow_data=P(TILE_AXIS),
        shadow_translucency=P(TILE_AXIS),
        obj_id=P(TILE_AXIS),
        motion_spec=P(TILE_AXIS),
    )


def render_frame_sharded(scene: FlatScene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Render a frame with rows sharded across the mesh devices.

    `cfg.height` must divide evenly by the device count. Returns a
    FrameOutput whose arrays are jax.Arrays sharded over the mesh
    (scalar `rays` is per-shard, shape [n_dev]).
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    if cfg.height % n_dev != 0:
        raise ValueError(f"height {cfg.height} not divisible by {n_dev} devices")
    return _render_sharded(scene, cfg, mesh)


@partial(jax.jit, static_argnums=(1, 2, 4))
def _render_pipeline_sharded(scene: FlatScene, cfg: RenderConfig, mesh: Mesh,
                             denoise_state, want_aux: bool = True):
    """Full frame pipeline under shard_map: render + denoise (halo-row
    collectives) + composite, rows sharded over the mesh.

    The engine-facing analog of runtime.engine._render_pipeline — same
    return contract — with every stage executing per-device: the denoiser
    exchanges halo rows with its mesh neighbors
    (post/denoise.py::denoise_frame_sharded) and the composite/tonemap are
    per-pixel. Output equals the single-device pipeline up to float
    re-association in the filters.
    """
    from ..post import composite as composite_mod
    from ..post import denoise as denoise_mod
    from ..post import tonemap

    n_dev = mesh.devices.size
    rows_per = cfg.height // n_dev

    def shard_fn(scene_rep, state_slab):
        i = jax.lax.axis_index(TILE_AXIS)
        out = render_rows(scene_rep, cfg, i * rows_per, rows_per,
                          pmap=_sharded_photon_map(scene_rep, cfg, n_dev))
        if cfg.enable_denoiser and state_slab is not None:
            dd, ds, dshadow, new_state = denoise_mod.denoise_frame_sharded(
                out.gbuffer, rows_per, cfg.width, state_slab,
                TILE_AXIS, n_dev, cfg.height,
            )
            denoised = (dd, ds, dshadow)
            color01 = composite_mod.composite(
                out.gbuffer, out.raw_specular, scene_rep.exposure,
                scene_rep.tone_map_operator, scene_rep.gamma,
                denoised_diffuse=dd, denoised_specular=ds, use_denoised=True,
                nrd_bypass_distance=scene_rep.nrd_bypass_distance,
                nrd_bypass_blend=scene_rep.nrd_bypass_blend,
            )
        else:
            new_state = state_slab
            denoised = None
            color01 = composite_mod.composite(
                out.gbuffer, out.raw_specular, scene_rep.exposure,
                scene_rep.tone_map_operator, scene_rep.gamma,
                use_denoised=False,
            )
        rgba = tonemap.to_rgba8(color01).reshape(rows_per, cfg.width, 4)
        if not want_aux:
            return rgba, None, out.rays.reshape(1), None, new_state, None
        hdr = out.color.reshape(rows_per, cfg.width, 3)
        return (rgba, hdr, out.rays.reshape(1), out.gbuffer,
                new_state, denoised)

    sharded = P(TILE_AXIS)
    state_specs = (None if denoise_state is None else
                   jax.tree_util.tree_map(lambda _: sharded, denoise_state))
    denoised_specs = ((sharded, sharded, sharded)
                      if (want_aux and cfg.enable_denoiser
                          and denoise_state is not None)
                      else None)
    specs_in = jax.tree_util.tree_map(lambda _: P(), scene)
    gb = _gbuffer_spec() if want_aux else None
    hdr_spec = sharded if want_aux else None
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(specs_in, state_specs),
        out_specs=(sharded, hdr_spec, sharded, gb, state_specs,
                   denoised_specs),
        check_vma=False,
    )(scene, denoise_state)


def render_pipeline_sharded(scene: FlatScene, cfg: RenderConfig,
                            mesh: Optional[Mesh] = None, denoise_state=None,
                            want_aux: bool = True):
    """Engine-level multi-device frame: returns (rgba[H,W,4]u8, hdr[H,W,3],
    rays[n_dev], gbuffer, new_state, denoised) with rows sharded.

    cfg.height must divide by the device count. `want_aux=False`
    (streaming/bench) skips the hdr/gbuffer/denoised aux outputs — None in
    those slots.
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    if cfg.height % n_dev != 0:
        raise ValueError(f"height {cfg.height} not divisible by {n_dev} devices")
    return _render_pipeline_sharded(scene, cfg, mesh, denoise_state, want_aux)
