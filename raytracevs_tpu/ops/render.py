"""Frame rendering: primary rays, the sample loop, and G-buffer assembly.

Replaces DXRPipeline::RenderWithDXR's DispatchRays + the tail of RayGen
(src/Shader/RayGen.hlsl:48-172 primary generation, :850-1044 G-buffer
output). Returns linear HDR color plus the full NRD-style G-buffer contract
(demodulated diffuse, specular, normal/roughness, viewZ, motion vectors,
albedo with material-class alpha, SIGMA shadow data) that post/ consumes.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..scene.flatten import FlatScene, RenderConfig
from . import sampling, wavefront

F32 = jnp.float32
I32 = jnp.int32


class GBuffer(NamedTuple):
    """NRD input G-buffer (Common.hlsli:538-545, NRDDenoiser.h:28-54)."""

    diffuse_hitdist: jnp.ndarray  # [N,4] demodulated diffuse + hitdist
    specular_hitdist: jnp.ndarray  # [N,4]
    normal_roughness: jnp.ndarray  # [N,4] view-space oct normal + sqrt roughness
    view_z: jnp.ndarray  # [N]
    motion: jnp.ndarray  # [N,2] pixel-space motion vectors
    albedo: jnp.ndarray  # [N,4] albedo + material-class alpha
    shadow_data: jnp.ndarray  # [N,2] (penumbra, visibility)
    shadow_translucency: jnp.ndarray  # [N,4] SIGMA packed translucency
    obj_id: jnp.ndarray  # [N] i32 packed object id (type*65536+index; -1 = sky)
    # [N,2] specular VIRTUAL-motion vectors (REBLUR virtual-motion
    # reprojection — see the motion_spec block in _assemble_frame);
    # None on paths that have not been taught to produce it (the
    # denoiser then reprojects specular with surface motion, as before)
    motion_spec: jnp.ndarray = None
    


class FrameOutput(NamedTuple):
    color: jnp.ndarray  # [N,3] linear HDR (RenderTarget before composite)
    gbuffer: GBuffer
    rays: jnp.ndarray  # [] f32 total rays traced (Mrays/s metric)
    raw_specular: jnp.ndarray  # [N,3] RawSpecularBackup (DXRPipeline.cpp:3736-3930)


def _mm(a, b):
    """float32 matrix product at full precision on every backend."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _oct_encode(n):
    """EncodeUnitVector (NRDEncoding.hlsli:73-79). n: [N,3] -> [N,2] in [0,1]."""
    s = jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    v = n / jnp.maximum(s, 1e-12)
    xy = v[:, :2]
    sign_xy = jnp.where(xy >= 0.0, 1.0, -1.0)
    wrapped = (1.0 - jnp.abs(xy[:, ::-1])) * sign_xy
    xy = jnp.where(v[:, 2:3] >= 0.0, xy, wrapped)
    return xy * 0.5 + 0.5


def primary_rays(scene: FlatScene, cfg: RenderConfig, px, py, sample_index, tile):
    """Primary ray per lane (RayGen.hlsl:107-172): blue-noise AA + thin-lens DoF."""
    n = px.shape[0]
    bn = sampling.sample_blue_noise(tile, px, py, scene.frame_index, sample_index)
    use_jitter = cfg.samples_per_pixel > 1  # static
    offset = bn[:, :2] if use_jitter else jnp.full((n, 2), 0.5, F32)

    pc_x = px.astype(F32) + offset[:, 0]
    pc_y = py.astype(F32) + offset[:, 1]
    ndc_x = pc_x / F32(cfg.width) * 2.0 - 1.0
    ndc_y = -(pc_y / F32(cfg.height) * 2.0 - 1.0)

    d = (
        scene.cam_forward[None, :]
        + scene.cam_right[None, :] * (ndc_x * scene.tan_half_fov * F32(cfg.aspect_ratio))[:, None]
        + scene.cam_up[None, :] * (ndc_y * scene.tan_half_fov)[:, None]
    )
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    origin = jnp.broadcast_to(scene.cam_pos[None, :], (n, 3))

    # DoF thin lens (RayGen.hlsl:124-138)
    dof = scene.aperture_size > 0.001
    focus = scene.cam_pos[None, :] + d * scene.focus_distance
    r = jnp.sqrt(bn[:, 2])
    theta = bn[:, 3] * F32(6.28318530718)
    disk = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1) * scene.aperture_size
    origin_dof = (
        scene.cam_pos[None, :]
        + scene.cam_right[None, :] * disk[:, 0:1]
        + scene.cam_up[None, :] * disk[:, 1:2]
    )
    d_dof = focus - origin_dof
    d_dof = d_dof / jnp.maximum(jnp.linalg.norm(d_dof, axis=-1, keepdims=True), 1e-12)
    origin = jnp.where(dof, origin_dof, origin)
    d = jnp.where(dof, d_dof, d)

    r = wavefront._empty_ray(n)
    return r._replace(
        valid=jnp.ones((n,), bool),
        origin=origin,
        direction=d,
        throughput=jnp.ones((n, 3), F32),
    )


def caustics_delta(scene: FlatScene, cfg: RenderConfig, pmap, prim_hit, prim_pos,
                   prim_normal, prim_metallic, prim_transmission):
    """Photon-caustic contribution at the recorded primary hits.

    The reference gathers photons in RayGen at depth 0 for diffuse surfaces
    (RayGen.hlsl:505-519: metallic<0.5, transmission<=0.01) and adds the
    result to both color and diffuse radiance with throughput 1. We gather
    ONCE per pixel at the first-hit record the main pass already produced
    and scale by spp: AA-jittered sample hits differ sub-pixel, far inside
    the 0.5-unit Gaussian gather radius, so the per-sample gather and the
    per-pixel gather are visually identical — and this avoids re-tracing
    every primary ray (which made a caustics frame ~500x slower).
    Returns (delta [N,3] summed over samples, replace_mask [N]).
    """
    from . import photon as photon_mod

    eligible = prim_hit & (prim_metallic < 0.5) & (prim_transmission <= 0.01)
    caustic = photon_mod.gather(pmap, prim_pos, prim_normal)
    delta = jnp.where(eligible[:, None], caustic, 0.0) * F32(cfg.samples_per_pixel)
    return delta, eligible


def render_rows(scene: FlatScene, cfg: RenderConfig, row_start, num_rows: int,
                pmap=None) -> FrameOutput:
    """Render `num_rows` image rows starting at traced offset `row_start`.

    This is the shardable unit: the pixel domain is the data-parallel axis
    (SURVEY §2.5 — image-row sharding replaces the reference's
    DispatchRays(W,H,1) pixel grid), so multi-device rendering runs this per
    device over a row slab with the scene replicated. `pmap` is a
    prebuilt photon map (the sharded path builds it across devices).
    """
    n = cfg.width * num_rows
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    px = idx % cfg.width
    py = jnp.asarray(row_start, jnp.int32) + idx // cfg.width
    tile = sampling.blue_noise_tile()

    zero3 = jnp.zeros((n, 3), F32)

    def sample_step(carry, s):
        (acc_color, acc_primary, acc_diffuse, acc_specular, acc_hitdist, acc_bounce,
         rays_total, prim_hit, prim_normal, prim_rough, prim_albedo, prim_metallic,
         prim_transmission, prim_pos, prim_shadow_vis, prim_shadow_pen,
         prim_shadow_dist, prim_obj_id) = carry
        su = s.astype(jnp.uint32)
        primary = primary_rays(scene, cfg, px, py, su, tile)
        acc = wavefront.run_sample(scene, cfg, px, py, su, primary, prim_hit)
        acc_color = acc_color + acc.sample_color
        acc_primary = acc_primary + acc.primary_contrib
        acc_diffuse = acc_diffuse + acc.diffuse
        acc_specular = acc_specular + acc.specular
        acc_hitdist = acc_hitdist + acc.hit_dist
        acc_bounce = acc_bounce + acc.bounce_count.astype(F32)
        rays_total = rays_total + jnp.sum(acc.rays.astype(F32))
        # SIGMA wants RAW first-sample shadow data (RayGen.hlsl:95-105)
        first = s == 0
        prim_shadow_vis = jnp.where(first, acc.shadow_vis, prim_shadow_vis)
        prim_shadow_pen = jnp.where(first, acc.shadow_pen, prim_shadow_pen)
        prim_shadow_dist = jnp.where(first, acc.shadow_dist, prim_shadow_dist)
        new_hit = acc.prim_hit & ~prim_hit
        prim_normal = jnp.where(new_hit[:, None], acc.prim_normal, prim_normal)
        prim_rough = jnp.where(new_hit, acc.prim_rough, prim_rough)
        prim_albedo = jnp.where(new_hit[:, None], acc.prim_albedo, prim_albedo)
        prim_metallic = jnp.where(new_hit, acc.prim_metallic, prim_metallic)
        prim_transmission = jnp.where(new_hit, acc.prim_transmission, prim_transmission)
        prim_pos = jnp.where(new_hit[:, None], acc.prim_pos, prim_pos)
        prim_obj_id = jnp.where(new_hit, acc.prim_obj_id, prim_obj_id)
        prim_hit = prim_hit | acc.prim_hit
        return (
            acc_color, acc_primary, acc_diffuse, acc_specular, acc_hitdist, acc_bounce,
            rays_total, prim_hit, prim_normal, prim_rough, prim_albedo, prim_metallic,
            prim_transmission, prim_pos, prim_shadow_vis, prim_shadow_pen,
            prim_shadow_dist, prim_obj_id,
        ), None

    init = (
        zero3, zero3, zero3, zero3, jnp.zeros((n,), F32), jnp.zeros((n,), F32),
        jnp.zeros((), F32), jnp.zeros((n,), bool),
        jnp.tile(jnp.array([0.0, 1.0, 0.0], F32), (n, 1)), jnp.ones((n,), F32),
        zero3, jnp.zeros((n,), F32), jnp.zeros((n,), F32), zero3,
        jnp.ones((n,), F32), jnp.zeros((n,), F32), jnp.full((n,), C.NRD_FP16_MAX, F32),
        jnp.full((n,), -1, jnp.int32),
    )
    carry, _ = jax.lax.scan(
        sample_step, init, jnp.arange(cfg.samples_per_pixel, dtype=jnp.int32)
    )
    (acc_color, acc_primary, acc_diffuse, acc_specular, acc_hitdist, acc_bounce,
     rays_total, prim_hit, prim_normal, prim_rough, prim_albedo, prim_metallic,
     prim_transmission, prim_pos, prim_shadow_vis, prim_shadow_pen,
     prim_shadow_dist, prim_obj_id) = carry
    c = _apply_caustics(
        scene, cfg, pmap=pmap,
        accs=dict(acc_color=acc_color, acc_primary=acc_primary, acc_diffuse=acc_diffuse,
             acc_specular=acc_specular, shadow_vis=prim_shadow_vis,
             shadow_pen=prim_shadow_pen, shadow_dist=prim_shadow_dist,
             prim_hit=prim_hit, prim_pos=prim_pos, prim_normal=prim_normal,
             prim_metallic=prim_metallic, prim_transmission=prim_transmission),
    )
    return _assemble_frame(
        scene, cfg, n, c["acc_color"], c["acc_primary"], c["acc_diffuse"],
        c["acc_specular"], acc_hitdist,
        acc_bounce, rays_total, prim_hit, prim_normal, prim_rough, prim_albedo,
        prim_metallic, prim_transmission, prim_pos, c["shadow_vis"], c["shadow_pen"],
        c["shadow_dist"], prim_obj_id,
    )


def _apply_caustics(scene, cfg, accs, pmap=None):
    """Photon pass: emit/trace/hash photons, fold the gathered caustic into
    the accumulators (RayGen.hlsl:505-533).

    accs is a dict with acc_color / acc_primary / acc_diffuse / acc_specular
    / shadow_vis / shadow_pen / shadow_dist; returns the same dict.

    PhotonDebugMode == 0 adds the caustic at eligible primary hits into
    color and diffuse. PhotonDebugMode > 0 instead REPLACES the primary
    contribution with caustic * PhotonDebugScale, zeroes specular, and
    clears the SIGMA shadow record (RayGen.hlsl:509-518). The replacement
    is applied per pixel rather than per sample: a pixel whose AA samples
    straddle an eligibility edge differs from the reference in those border
    samples only (debug visualization)."""
    if cfg.num_photons <= 0:
        return accs
    from . import photon as photon_mod

    if pmap is None:
        pmap = photon_mod.emit_and_trace(scene, cfg.num_photons)
    delta, mask = caustics_delta(
        scene, cfg, pmap, accs["prim_hit"], accs["prim_pos"], accs["prim_normal"],
        accs["prim_metallic"], accs["prim_transmission"],
    )
    accs = {k: v for k, v in accs.items() if not k.startswith("prim_")}
    out = dict(accs)
    if cfg.photon_debug_mode == 0:
        out["acc_color"] = accs["acc_color"] + delta
        out["acc_diffuse"] = accs["acc_diffuse"] + delta
        return out
    dbg = delta * F32(cfg.photon_debug_scale)
    m = mask[:, None]
    # acc_primary is the summed depth-0 contribution, so subtracting it and
    # adding the debug color reproduces the per-sample payload replacement
    # while keeping secondary-bounce terms (mode 1 shows acc - primary).
    out["acc_color"] = jnp.where(m, accs["acc_color"] - accs["acc_primary"] + dbg,
                                 accs["acc_color"])
    out["acc_primary"] = jnp.where(m, dbg, accs["acc_primary"])
    out["acc_diffuse"] = jnp.where(m, dbg, accs["acc_diffuse"])
    out["acc_specular"] = jnp.where(m, 0.0, accs["acc_specular"])
    out["shadow_vis"] = jnp.where(mask, 1.0, accs["shadow_vis"])
    out["shadow_pen"] = jnp.where(mask, 0.0, accs["shadow_pen"])
    out["shadow_dist"] = jnp.where(mask, F32(C.NRD_FP16_MAX), accs["shadow_dist"])
    return out


def _assemble_frame(scene, cfg, n, acc_color, acc_primary, acc_diffuse, acc_specular,
                    acc_hitdist, acc_bounce, rays_total, prim_hit, prim_normal, prim_rough,
                    prim_albedo, prim_metallic, prim_transmission, prim_pos,
                    prim_shadow_vis, prim_shadow_pen, prim_shadow_dist,
                    prim_obj_id=None) -> FrameOutput:
    """G-buffer assembly from per-sample accumulators (RayGen.hlsl:850-1044)."""
    inv = F32(1.0 / cfg.samples_per_pixel)
    final_color = acc_color * inv
    avg_bounce = acc_bounce * inv

    # Photon debug modes 1/2 (RayGen.hlsl:859-891)
    if cfg.photon_debug_mode == 2:
        ratio = jnp.clip(avg_bounce / F32(max(cfg.max_bounces, 1)), 0.0, 1.0)
        final_color = jnp.broadcast_to(ratio[:, None], (n, 3))
    elif cfg.photon_debug_mode == 1:
        final_color = jnp.maximum((acc_color - acc_primary) * inv, 0.0)

    world_normal = jnp.where(prim_hit[:, None], prim_normal,
                             jnp.array([0.0, 1.0, 0.0], F32)[None, :])
    out_rough = jnp.where(prim_hit, prim_rough, 1.0)
    out_albedo = jnp.where(prim_hit[:, None], prim_albedo, 1.0)

    # Material classification (RayGen.hlsl:913-963)
    spec_dom = jnp.maximum(prim_transmission, prim_metallic)
    blend = 1.0 - _smoothstep(0.3, 0.7, spec_dom)
    diffuse_mod = acc_diffuse * inv
    direct_spec = acc_specular * inv
    secondary = jnp.maximum(final_color - diffuse_mod - direct_spec, 0.0)
    safe_albedo = jnp.maximum(out_albedo, 0.04)

    demod = diffuse_mod / safe_albedo
    # > 0.7: all specular; 0.3-0.7: blended; < 0.3: demodulated diffuse
    diffuse_nrd = jnp.where(
        prim_hit[:, None],
        jnp.where(
            (spec_dom > 0.7)[:, None],
            0.0,
            jnp.where((spec_dom > 0.3)[:, None], demod * blend[:, None], demod),
        ),
        final_color,
    )
    spec_mid = final_color + (direct_spec + secondary - final_color) * blend[:, None]
    specular_nrd = jnp.where(
        prim_hit[:, None],
        jnp.where(
            (spec_dom > 0.7)[:, None],
            final_color,
            jnp.where((spec_dom > 0.3)[:, None], spec_mid, direct_spec + secondary),
        ),
        0.0,
    )

    mean_hitdist = acc_hitdist * inv
    diffuse_hitdist = jnp.concatenate([diffuse_nrd, mean_hitdist[:, None]], axis=-1)
    specular_hitdist = jnp.concatenate([specular_nrd, mean_hitdist[:, None]], axis=-1)

    # NRD inputs (NRDEncoding.hlsli:302-376)
    view_n = jnp.stack(
        [
            jnp.sum(world_normal * scene.cam_right[None, :], axis=-1),
            jnp.sum(world_normal * scene.cam_up[None, :], axis=-1),
            jnp.sum(world_normal * scene.cam_forward[None, :], axis=-1),
        ],
        axis=-1,
    )
    view_n = view_n / jnp.maximum(jnp.linalg.norm(view_n, axis=-1, keepdims=True), 1e-12)
    view_z = jnp.where(
        prim_hit,
        jnp.maximum(
            jnp.sum((prim_pos - scene.cam_pos[None, :]) * scene.cam_forward[None, :], axis=-1),
            C.VIEWZ_MIN,
        ),
        F32(C.VIEWZ_SKY),
    )
    normal_roughness = jnp.concatenate(
        [
            _oct_encode(view_n),
            jnp.where(view_n[:, 2] >= 0.0, 1.0, 0.0)[:, None],
            jnp.sqrt(jnp.clip(out_rough, 0.0, 1.0))[:, None],
        ],
        axis=-1,
    )

    # Motion vectors via current/previous view-projection (NRDEncoding.hlsli:352-369).
    # Full float32 products (_mm): a TF32 contraction would perturb the
    # motion vectors, and with them the denoiser's reprojection.
    p4 = jnp.concatenate([prim_pos, jnp.ones((n, 1), F32)], axis=-1)
    curr_clip = _mm(p4, scene.view_proj)
    prev_clip = _mm(p4, scene.prev_view_proj)
    curr_ndc = curr_clip[:, :2] / jnp.where(jnp.abs(curr_clip[:, 3:4]) < 1e-9, 1.0,
                                            curr_clip[:, 3:4])
    prev_ndc = prev_clip[:, :2] / jnp.where(jnp.abs(prev_clip[:, 3:4]) < 1e-9, 1.0,
                                            prev_clip[:, 3:4])
    # Pixel space, current minus previous: NDC y points up and pixel rows
    # down, so the row component changes sign (the denoiser reprojects
    # pixel (x, y) from (x - mv.x, y - mv.y)).
    ndc_to_px = jnp.array([cfg.width * 0.5, -cfg.height * 0.5], F32)[None, :]
    mv = (curr_ndc - prev_ndc) * ndc_to_px
    mv = jnp.clip(mv, -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
    mv = jnp.where(prim_hit[:, None], mv, 0.0)

    # Specular VIRTUAL-motion vectors (REBLUR specular virtual-motion
    # reprojection — the NRD-internal behavior NRDDenoiser.cpp's
    # settings block configures): a mirror reflection's image lies at
    # the virtual point Xv = X + V*hitDist, the primary ray extended
    # past the surface — so under camera motion the specular history
    # must be fetched where Xv reprojects, not where the surface was
    # (surface motion ghosts moving reflections). The virtual distance
    # scales by (1 - roughness): rougher reflections behave
    # increasingly surface-attached (virtualHistoryAmount analog).
    # Static camera => prev VP == VP => mv_spec == mv bit-for-bit.
    vview = prim_pos - scene.cam_pos[None, :]
    vdirn = vview / jnp.maximum(
        jnp.linalg.norm(vview, axis=-1, keepdims=True), 1e-9)
    v_amount = jnp.clip(1.0 - out_rough, 0.0, 1.0)
    xv = prim_pos + vdirn * (jnp.maximum(mean_hitdist, 0.0) * v_amount)[:, None]
    p4v = jnp.concatenate([xv, jnp.ones((n, 1), F32)], axis=-1)
    cv = _mm(p4v, scene.view_proj)
    pv = _mm(p4v, scene.prev_view_proj)
    cvn = cv[:, :2] / jnp.where(jnp.abs(cv[:, 3:4]) < 1e-9, 1.0, cv[:, 3:4])
    pvn = pv[:, :2] / jnp.where(jnp.abs(pv[:, 3:4]) < 1e-9, 1.0, pv[:, 3:4])
    mv_spec = (cvn - pvn) * ndc_to_px
    mv_spec = jnp.clip(mv_spec, -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
    mv_spec = jnp.where(prim_hit[:, None], mv_spec, 0.0)

    # Material alpha for Composite (RayGen.hlsl:987-1000)
    material_alpha = jnp.where(
        prim_hit,
        jnp.where(spec_dom > 0.5, 0.5, 0.75 + (1.0 - 0.75) * blend),
        0.0,
    )
    albedo_out = jnp.concatenate([out_albedo, material_alpha[:, None]], axis=-1)

    # SIGMA shadow inputs from the RAW first sample (RayGen.hlsl:1002-1039)
    sigma_pen = jnp.where(
        prim_shadow_vis > C.SHADOW_FULLY_LIT_THRESHOLD,
        F32(C.NRD_FP16_MAX),
        jnp.clip(prim_shadow_pen, C.SIGMA_PENUMBRA_MIN, C.SIGMA_PENUMBRA_PRACTICAL_MAX),
    )
    vis_clean = jnp.clip(prim_shadow_vis, 0.0, 1.0)
    vis_clean = jnp.where(jnp.isfinite(vis_clean), vis_clean, 1.0)
    sigma_pen = jnp.where(jnp.isfinite(sigma_pen), sigma_pen, C.NRD_FP16_MAX)
    shadow_data = jnp.stack([sigma_pen, vis_clean], axis=-1)
    shadow_translucency = jnp.concatenate(
        [(prim_shadow_dist >= C.NRD_FP16_MAX).astype(F32)[:, None], jnp.zeros((n, 3), F32)],
        axis=-1,
    )

    return FrameOutput(  # noqa: B012
        color=final_color,
        gbuffer=GBuffer(
            diffuse_hitdist=diffuse_hitdist,
            specular_hitdist=specular_hitdist,
            normal_roughness=normal_roughness,
            view_z=view_z,
            motion=mv,
            albedo=albedo_out,
            shadow_data=shadow_data,
            shadow_translucency=shadow_translucency,
            obj_id=(prim_obj_id if prim_obj_id is not None
                    else jnp.full((n,), -1, jnp.int32)),
            motion_spec=mv_spec,
        ),
        rays=rays_total,
        raw_specular=specular_nrd,
    )


@partial(jax.jit, static_argnums=(1,))
def render_frame(scene: FlatScene, cfg: RenderConfig) -> FrameOutput:
    """Render one full frame single-device; lanes are the flattened H*W pixels."""
    return render_rows(scene, cfg, jnp.int32(0), cfg.height)
