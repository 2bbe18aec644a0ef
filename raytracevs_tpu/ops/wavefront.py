"""Wavefront render core.

Data-parallel reformulation of the reference's RayGen wavefront driver
(src/Shader/RayGen.hlsl:48-1045). The reference runs, per GPU thread, a
per-pixel LIFO WorkItem queue (stride 8) that traces one ray per pop and
pushes up to two children (glass reflect+refract, metal reflect). Here the
same DFS executes as one SIMD program over every pixel lane at once:

- a "current ray" register file [N,...] holds the item being traced,
- a per-lane stack [N,8,...] holds deferred siblings (only the glass
  reflect branch is ever actually deferred, because LIFO pops the most
  recently pushed child immediately — so pushes/pops touch at most one
  stack slot per lane per iteration),
- a `lax.while_loop` iterates until every lane's stack is empty.

Radiance accumulation, budgets (RayGen.hlsl:69-77), throughput threshold,
sky fallbacks, NaN guards, child-throughput rules, and the depth-0 NRD
G-buffer records follow the reference exactly; see inline citations.

Dead WorkItem fields are dropped deliberately: `absorption` (the path
medium sigmaA) is carried by the reference but shading reads only the hit
material's absorption (RayGen.hlsl:675); `mediumEta` is written but never
read; `specularDepth`/`diffuseDepth` only feed the Russian-roulette gate
(RayGen.hlsl:597) which can never fire because diffuseDepth is never
incremented — so the RR branch is statically dead and omitted here.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from ..scene.flatten import FlatScene, RenderConfig
from . import intersect, sampling, shade

F32 = jnp.float32
I32 = jnp.int32
U32 = jnp.uint32

_INVALID = 0x7FFFFFF  # stands in for OBJECT_TYPE_INVALID in i32 math
STACK_DEPTH = C.WORK_QUEUE_STRIDE
_RAY_F = 10  # origin3 dir3 throughput3 sky_boost
_RAY_I = 5  # depth flags ray_flags skip_type skip_index


class RayState(NamedTuple):
    """Live WorkItem fields (Common.hlsli:194-212) as SoA lane registers."""

    valid: jnp.ndarray  # [N] bool
    origin: jnp.ndarray  # [N,3]
    direction: jnp.ndarray  # [N,3]
    depth: jnp.ndarray  # [N] i32
    throughput: jnp.ndarray  # [N,3]
    flags: jnp.ndarray  # [N] i32 PATH_FLAG_*
    sky_boost: jnp.ndarray  # [N]
    ray_flags: jnp.ndarray  # [N] i32 RAYFLAG_*
    skip_type: jnp.ndarray  # [N] i32
    skip_index: jnp.ndarray  # [N] i32


def _empty_ray(n):
    return RayState(
        valid=jnp.zeros((n,), bool),
        origin=jnp.zeros((n, 3), F32),
        direction=jnp.tile(jnp.array([0.0, 0.0, 1.0], F32), (n, 1)),
        depth=jnp.zeros((n,), I32),
        throughput=jnp.zeros((n, 3), F32),
        flags=jnp.zeros((n,), I32),
        sky_boost=jnp.ones((n,), F32),
        ray_flags=jnp.zeros((n,), I32),
        skip_type=jnp.full((n,), _INVALID, I32),
        skip_index=jnp.zeros((n,), I32),
    )


class Stack(NamedTuple):
    """Per-lane LIFO of deferred WorkItems (the WorkQueue UAV, stride 8)."""

    f: jnp.ndarray  # [N,8,_RAY_F]
    i: jnp.ndarray  # [N,8,_RAY_I]
    count: jnp.ndarray  # [N] i32


def _empty_stack(n):
    return Stack(
        f=jnp.zeros((n, STACK_DEPTH, _RAY_F), F32),
        i=jnp.zeros((n, STACK_DEPTH, _RAY_I), I32),
        count=jnp.zeros((n,), I32),
    )


def _pack_ray_f(r: RayState):
    return jnp.concatenate(
        [r.origin, r.direction, r.throughput, r.sky_boost[:, None]], axis=-1
    )


def _pack_ray_i(r: RayState):
    return jnp.stack([r.depth, r.flags, r.ray_flags, r.skip_type, r.skip_index], axis=-1)


def _unpack_ray(fv, iv, valid):
    return RayState(
        valid=valid,
        origin=fv[:, 0:3],
        direction=fv[:, 3:6],
        depth=iv[:, 0],
        throughput=fv[:, 6:9],
        flags=iv[:, 1],
        sky_boost=fv[:, 9],
        ray_flags=iv[:, 2],
        skip_type=iv[:, 3],
        skip_index=iv[:, 4],
    )


def _stack_push(stack: Stack, ray: RayState, do_push):
    """Push `ray` on lanes where do_push (caller guarantees count < depth)."""
    slot = jnp.clip(stack.count, 0, STACK_DEPTH - 1)
    onehot = (jnp.arange(STACK_DEPTH, dtype=I32)[None, :] == slot[:, None]) & do_push[:, None]
    f = jnp.where(onehot[:, :, None], _pack_ray_f(ray)[:, None, :], stack.f)
    i = jnp.where(onehot[:, :, None], _pack_ray_i(ray)[:, None, :], stack.i)
    return Stack(f=f, i=i, count=stack.count + do_push.astype(I32))


def _stack_pop(stack: Stack, do_pop):
    """Pop on lanes where do_pop & count>0; returns (stack, ray, popped_mask)."""
    can = do_pop & (stack.count > 0)
    slot = jnp.clip(stack.count - 1, 0, STACK_DEPTH - 1)
    onehot = (jnp.arange(STACK_DEPTH, dtype=I32)[None, :] == slot[:, None]).astype(F32)
    fv = jnp.sum(stack.f * onehot[:, :, None], axis=1)
    iv = jnp.sum(stack.i * onehot[:, :, None].astype(I32), axis=1)
    ray = _unpack_ray(fv, iv, can)
    return Stack(f=stack.f, i=stack.i, count=stack.count - can.astype(I32)), ray, can


class SampleAccum(NamedTuple):
    sample_color: jnp.ndarray  # [N,3]
    primary_contrib: jnp.ndarray  # [N,3]
    bounce_count: jnp.ndarray  # [N] i32
    rays: jnp.ndarray  # [N] i32  (all TraceRay-equivalents, for Mrays/s)
    # depth-0 NRD payload records (RayGen.hlsl:560-589)
    diffuse: jnp.ndarray  # [N,3]
    specular: jnp.ndarray  # [N,3]
    hit_dist: jnp.ndarray  # [N]
    shadow_vis: jnp.ndarray  # [N]
    shadow_pen: jnp.ndarray  # [N]
    shadow_dist: jnp.ndarray  # [N]
    prim_hit: jnp.ndarray  # [N] bool
    prim_normal: jnp.ndarray  # [N,3]
    prim_rough: jnp.ndarray  # [N]
    prim_albedo: jnp.ndarray  # [N,3]
    prim_metallic: jnp.ndarray  # [N]
    prim_transmission: jnp.ndarray  # [N]
    prim_pos: jnp.ndarray  # [N,3]
    prim_obj_id: jnp.ndarray  # [N] i32: obj_type*65536+index at primary, -1 = miss


def _reflect(i, n):
    return i - 2.0 * jnp.sum(i * n, axis=-1, keepdims=True) * n


def _refract(i, n, eta):
    """HLSL refract(): returns (dir, tir_mask)."""
    cosi = jnp.sum(n * i, axis=-1)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    kk = jnp.sqrt(jnp.maximum(k, 0.0))
    r = eta[:, None] * i - (eta * cosi + kk)[:, None] * n
    return jnp.where(tir[:, None], 0.0, r), tir


def _max3(v):
    return jnp.max(v, axis=-1)


def _shade_and_spawn(scene: FlatScene, cfg: RenderConfig, px, py, sample_index, state: RayState,
                     traced):
    """Trace + shade one WorkItem per lane; return contribution, records, children.

    Mirrors the body of the RayGen while-loop (RayGen.hlsl:174-848).
    """
    n = px.shape[0]
    tmin = jnp.full((n,), C.RAY_TMIN, F32)
    tmax = jnp.full((n,), C.RAY_TMAX, F32)
    skip_t = jnp.where((state.ray_flags & C.RAYFLAG_SKIP_SELF) != 0, state.skip_type, _INVALID)
    skip_i = jnp.where((state.ray_flags & C.RAYFLAG_SKIP_SELF) != 0, state.skip_index, 0)
    # Deferred mesh-glass thickness:
    # a refract child tagged with instance+1 in ray_flags bits 8+ resolves
    # its same-instance thickness during this closest walk — its ray IS the
    # reference's thickness ray (RayGen.hlsl:650/776 share the origin) —
    # and the Beer factor the reference applied at spawn multiplies the
    # path here instead; the product is identical.
    fused_thick = scene.mesh is not None and cfg.any_absorption
    beer = None
    if fused_thick:
        thick_inst = jnp.where(traced, (state.ray_flags >> 8) - 1, -1)
        hit = intersect.trace_closest(
            scene, state.origin, state.direction, tmin, tmax, skip_t, skip_i,
            thick_inst=thick_inst,
        )
        t_th = jnp.where((thick_inst >= 0) & hit.thick_hit, hit.thick_t, 0.0)
        tscale = t_th * F32(C.GLASS_ABSORPTION_SCALE)
        ni = scene.mesh.inst_absorption.shape[0]
        ab = scene.mesh.inst_absorption[jnp.clip(thick_inst, 0, ni - 1)]
        beer = jnp.where((t_th > 0.0)[:, None], jnp.exp(-ab * tscale[:, None]), 1.0)
        state = state._replace(throughput=state.throughput * beer)
    else:
        hit = intersect.trace_closest(
            scene, state.origin, state.direction, tmin, tmax, skip_t, skip_i
        )
    hit_mask = hit.hit & traced
    pos, nrm, front_face = intersect.surface_normal(scene, hit, state.origin, state.direction)

    # Material fetch (ClosestHit.hlsl:54-125)
    slot = hit.mat_slot
    albedo = scene.mat_color[slot][:, :3]
    metallic = scene.mat_metallic[slot]
    roughness = scene.mat_roughness[slot]
    transmission = scene.mat_transmission[slot]
    ior = scene.mat_ior[slot]
    specular = scene.mat_specular[slot]
    emission = scene.mat_emission[slot]
    absorption = scene.mat_absorption[slot]

    if scene.plane_capacity > 0:
        is_plane = hit.obj_type == C.OBJECT_TYPE_PLANE
        checker = shade.checker_albedo(
            albedo, pos, scene.cam_pos[None, :], scene.cam_forward[None, :]
        )
        albedo = jnp.where(is_plane[:, None], checker, albedo)
        transmission = jnp.where(is_plane, 0.0, transmission)
        ior = jnp.where(is_plane, 1.5, ior)  # plane branch leaves ior at default

    view = -state.direction
    is_glass = transmission > 0.01
    l_cap = scene.lt_type.shape[0]

    # ---- Glass: specular highlights only (RayGen.hlsl:283-334) ----------
    f0_from_ior = jnp.square((ior - 1.0) / (ior + 1.0))
    spec_blend = jnp.clip(specular, 0.0, 1.0)
    f0_glass = f0_from_ior + (spec_blend - f0_from_ior) * spec_blend
    highlight = jnp.zeros((n, 3), F32)
    if cfg.any_glass and cfg.has_lights:
        for li in range(l_cap):
            lv = (li < scene.num_lights) & scene.lt_valid[li]
            lt = scene.lt_type[li]
            non_ambient = lv & (lt != C.LIGHT_TYPE_AMBIENT)
            lpos = scene.lt_position[li][None, :]
            is_dir = lt == C.LIGHT_TYPE_DIRECTIONAL
            to_l = lpos - pos
            dist = jnp.linalg.norm(to_l, axis=-1)
            l_vec = jnp.where(
                is_dir,
                -lpos / jnp.maximum(jnp.linalg.norm(lpos), 1e-12),
                to_l / jnp.maximum(dist[:, None], 1e-12),
            )
            atten = jnp.where(
                is_dir,
                1.0,
                shade.compute_attenuation(
                    dist, scene.atten_const, scene.atten_linear, scene.atten_quadratic
                ),
            )
            ndotl = jnp.maximum(0.0, jnp.sum(nrm * l_vec, axis=-1))
            half = l_vec + view
            half = half / jnp.maximum(jnp.linalg.norm(half, axis=-1, keepdims=True), 1e-12)
            shininess = jnp.maximum(64.0, 512.0 * (1.0 - roughness))
            spec = jnp.power(jnp.maximum(0.0, jnp.sum(nrm * half, axis=-1)), shininess)
            sf = shade.fresnel_schlick(jnp.maximum(0.0, jnp.sum(half * view, axis=-1)), f0_glass)
            contrib = scene.lt_color[li][None, :3] * (
                scene.lt_intensity[li] * spec * sf * atten
            )[:, None]
            highlight = highlight + jnp.where((non_ambient & (ndotl > 0.0))[:, None], contrib, 0.0)
        highlight = highlight * (spec_blend * (1.0 - roughness))[:, None]
        highlight = jnp.where((specular > 0.01)[:, None], highlight, 0.0)
    glass_color = highlight + emission

    # ---- Non-glass: PBR direct lighting (RayGen.hlsl:336-539) -----------
    f0 = 0.04 + (albedo - 0.04) * metallic[:, None]
    diffuse_color = albedo * (1.0 - metallic)[:, None]

    sample_idx_rng = sampling.u32(sample_index) + state.depth.astype(U32) * U32(4096)
    seed = sampling.rng_init(px, py, scene.frame_index, sample_idx_rng, C.RNG_SALT_SHADOW)

    shade_mask = hit_mask & ~is_glass

    ambient = jnp.zeros((n, 3), F32)
    direct_diffuse = jnp.zeros((n, 3), F32)
    direct_specular = jnp.zeros((n, 3), F32)
    best_vis = jnp.ones((n,), F32)
    best_pen = jnp.zeros((n,), F32)
    best_dist = jnp.full((n,), C.NRD_FP16_MAX, F32)
    ray_count = jnp.zeros((n,), I32)

    def light_geom(li_idx):
        lt = scene.lt_type[li_idx]
        lpos = scene.lt_position[li_idx]
        is_dir = lt == C.LIGHT_TYPE_DIRECTIONAL
        to_l = lpos - pos
        dist = jnp.linalg.norm(to_l, axis=-1)
        ldn = lpos / jnp.maximum(jnp.linalg.norm(lpos, axis=-1, keepdims=True), 1e-12)
        l_vec = jnp.where(is_dir[:, None], -ldn, to_l / jnp.maximum(dist[:, None], 1e-12))
        atten = jnp.where(
            is_dir,
            1.0,
            shade.compute_attenuation(
                dist, scene.atten_const, scene.atten_linear, scene.atten_quadratic
            ),
        )
        ndotl = jnp.maximum(jnp.sum(nrm * l_vec, axis=-1), 0.0)
        return lt, lpos, l_vec, atten, ndotl

    if cfg.has_lights:
        top0_i, top0_c, top1_i, top1_c, top_count = shade.select_dominant_lights(scene, pos, nrm)
        sel0 = (top_count > 0) & (top0_c > 0.0)
        sel1 = (top_count > 1) & (top1_c > 0.0)

        # Shadow rays only for the (<=2) dominant lights, consumed in
        # light-index order to preserve the reference's sequential RNG stream.
        a_idx = jnp.where(
            sel0 & sel1, jnp.minimum(top0_i, top1_i), jnp.where(sel0, top0_i, top1_i)
        )
        b_idx = jnp.where(sel0 & sel1, jnp.maximum(top0_i, top1_i), a_idx)
        a_sel = sel0 | sel1
        b_sel = sel0 & sel1

        shadow_results = {}
        for which, idx, selm in (("a", a_idx, a_sel), ("b", b_idx, b_sel)):
            lt, lpos, l_vec, atten, ndotl = light_geom(idx)
            samples = shade.compute_shadow_samples(
                scene.lt_samples[idx], top0_i, top0_c, top1_i, top1_c, idx
            )
            active = shade_mask & selm & (ndotl > 0.0)
            seed, res = shade.calculate_soft_shadow(
                scene, pos, nrm, active, lt, lpos, scene.lt_radius[idx],
                samples.astype(F32), seed, max_samples=cfg.max_soft_samples,
            )
            shadow_results[which] = res
            ray_count = ray_count + jnp.where(active, res.rays, 0)

        best_w = jnp.full((n,), -1.0, F32)
        for li in range(l_cap):
            lv = (li < scene.num_lights) & scene.lt_valid[li]
            lt, lpos, l_vec, atten, ndotl = light_geom(jnp.full((n,), li, I32))
            is_ambient = scene.lt_type[li] == C.LIGHT_TYPE_AMBIENT
            lcol = scene.lt_color[li][None, :3]
            lint = scene.lt_intensity[li]

            amb = lcol * lint * (
                diffuse_color + (albedo * 0.3 - diffuse_color) * metallic[:, None]
            )
            ambient = ambient + jnp.where((lv & is_ambient), 1.0, 0.0) * amb

            lit = lv & ~is_ambient & (ndotl > 0.0)
            use_a = (a_idx == li) & a_sel
            use_b = (b_idx == li) & b_sel
            vis = jnp.where(
                use_a,
                shadow_results["a"].visibility,
                jnp.where(use_b, shadow_results["b"].visibility, 1.0),
            )
            pen = jnp.where(
                use_a,
                shadow_results["a"].penumbra,
                jnp.where(use_b, shadow_results["b"].penumbra, 0.0),
            )
            occ = jnp.where(
                use_a,
                shadow_results["a"].occluder_distance,
                jnp.where(use_b, shadow_results["b"].occluder_distance, C.NRD_FP16_MAX),
            )
            scol = jnp.where(
                use_a[:, None],
                shadow_results["a"].shadow_color,
                jnp.where(use_b[:, None], shadow_results["b"].shadow_color, 1.0),
            )

            # depth-0 best shadow for SIGMA (RayGen.hlsl:415-423)
            w = ndotl * atten * lint
            better = lit & (state.depth == 0) & (w > best_w)
            best_w = jnp.where(better, w, best_w)
            best_vis = jnp.where(better, vis, best_vis)
            best_pen = jnp.where(better, pen, best_pen)
            best_dist = jnp.where(better, occ, best_dist)

            shadow_amount = jnp.clip((1.0 - vis) * scene.shadow_strength, 0.0, 1.0)
            adj_vis = 1.0 - shadow_amount
            radiance = lcol * (lint * atten * adj_vis)[:, None] * scol

            half = view + l_vec
            half = half / jnp.maximum(jnp.linalg.norm(half, axis=-1, keepdims=True), 1e-12)
            ndotv = jnp.maximum(jnp.sum(nrm * view, axis=-1), 0.001)
            ndoth = jnp.maximum(jnp.sum(nrm * half, axis=-1), 0.0)
            vdoth = jnp.maximum(jnp.sum(view * half, axis=-1), 0.0)
            fr = shade.fresnel_schlick3(vdoth, f0)
            d = shade.ggx_d(ndoth, jnp.maximum(roughness, 0.04))
            g = shade.smith_g(ndotv, ndotl, roughness)
            spec_brdf = (d * g)[:, None] * fr / (4.0 * ndotv * ndotl + 0.001)[:, None]
            kd = (1.0 - fr) * (1.0 - metallic)[:, None]
            diff_brdf = kd * diffuse_color / jnp.float32(C.PI)

            m = lit[:, None]
            direct_diffuse = direct_diffuse + jnp.where(
                m, diff_brdf * radiance * ndotl[:, None], 0.0
            )
            direct_specular = direct_specular + jnp.where(
                m, spec_brdf * radiance * ndotl[:, None], 0.0
            )
    else:
        # No-light fallback (RayGen.hlsl:452-501): legacy point light + flat
        # ambient, only at depth 0.
        fb_pos = jnp.array([3.0, 5.0, -3.0], F32)
        fb_needed = state.depth == 0
        to_l = fb_pos[None, :] - pos
        fb_dist = jnp.linalg.norm(to_l, axis=-1)
        fb_l = to_l / jnp.maximum(fb_dist[:, None], 1e-12)
        fb_atten = shade.compute_attenuation(
            fb_dist, scene.atten_const, scene.atten_linear, scene.atten_quadratic
        )
        fb_ndotl = jnp.maximum(jnp.sum(nrm * fb_l, axis=-1), 0.0)
        fb_active = shade_mask & fb_needed
        fb_vis, fb_scol, fb_occ = intersect.trace_shadow(
            scene, pos + nrm * F32(C.SHADOW_NORMAL_OFFSET), fb_l, fb_dist
        )
        ray_count = ray_count + fb_active.astype(I32)
        fb_amount = jnp.clip((1.0 - fb_vis) * scene.shadow_strength, 0.0, 1.0)
        fb_radiance = (F32(1.5) * fb_atten * (1.0 - fb_amount))[:, None] * fb_scol
        fb_half = view + fb_l
        fb_half = fb_half / jnp.maximum(jnp.linalg.norm(fb_half, axis=-1, keepdims=True), 1e-12)
        fb_ndotv = jnp.maximum(jnp.sum(nrm * view, axis=-1), 0.001)
        fb_ndoth = jnp.maximum(jnp.sum(nrm * fb_half, axis=-1), 0.0)
        fb_vdoth = jnp.maximum(jnp.sum(view * fb_half, axis=-1), 0.0)
        fb_fr = shade.fresnel_schlick3(fb_vdoth, f0)
        fb_d = shade.ggx_d(fb_ndoth, jnp.maximum(roughness, 0.04))
        fb_g = shade.smith_g(fb_ndotv, fb_ndotl, roughness)
        fb_spec = (fb_d * fb_g)[:, None] * fb_fr / (4.0 * fb_ndotv * fb_ndotl + 0.001)[:, None]
        fb_kd = (1.0 - fb_fr) * (1.0 - metallic)[:, None]
        fb_diff = fb_kd * diffuse_color / jnp.float32(C.PI)
        fb_lit = ((fb_ndotl > 0.0) & fb_needed)[:, None]
        direct_diffuse = jnp.where(fb_lit, fb_diff * fb_radiance * fb_ndotl[:, None], 0.0)
        direct_specular = jnp.where(fb_lit, fb_spec * fb_radiance * fb_ndotl[:, None], 0.0)
        fb_amb = (diffuse_color + (albedo * 0.3 - diffuse_color) * metallic[:, None]) * 0.2
        ambient = jnp.where(fb_needed[:, None], fb_amb, ambient)
        best_vis = jnp.where(fb_needed, fb_vis, best_vis)
        best_dist = jnp.where(
            fb_needed, jnp.where(fb_vis < 0.99, fb_occ, C.NRD_FP16_MAX), best_dist
        )

    reflection_weight = metallic * (1.0 - roughness * 0.5)
    direct_weight = 1.0 - reflection_weight * 0.5
    photon = jnp.zeros((n, 3), F32)  # M4: photon-mapped caustics

    final = ambient + direct_diffuse * direct_weight[:, None] + direct_specular + photon + emission
    final = jnp.maximum(final, 0.0)

    color = jnp.where(is_glass[:, None], glass_color, final)
    # Photon debug 3/4: transmission/metallic grayscale at depth 0
    # (ClosestHit.hlsl:141-157); secondary bounces still contribute.
    if cfg.photon_debug_mode in (3, 4):
        v = jnp.clip(transmission if cfg.photon_debug_mode == 3 else metallic, 0.0, 1.0)
        dbg = jnp.stack([v, v, v], axis=-1)
        dbg_on = (state.depth == 0) & hit_mask
        color = jnp.where(dbg_on[:, None], dbg, color)
    # Miss: sky * pathSkyBoost (Miss.hlsl:4-16)
    sky = shade.sky_color(state.direction)
    miss_color = sky * state.sky_boost[:, None]
    color = jnp.where(hit_mask[:, None], color, miss_color)
    # NaN/Inf guard (RayGen.hlsl:250-260)
    bad = ~jnp.all(jnp.isfinite(color), axis=-1)
    color = jnp.where(bad[:, None], state.throughput * sky, color)

    # Depth-0 NRD payload fields (RayGen.hlsl:328-334, 531-538; Miss.hlsl:12-17)
    diff_rad = ambient + direct_diffuse * direct_weight[:, None] + photon + emission
    diff_rad = jnp.where(is_glass[:, None], 0.0, diff_rad)
    diff_rad = jnp.where(hit_mask[:, None], diff_rad, sky * state.sky_boost[:, None])
    spec_rad = jnp.where(is_glass[:, None], highlight, direct_specular)
    spec_rad = jnp.where(hit_mask[:, None], spec_rad, 0.0)
    if cfg.photon_debug_mode in (3, 4):
        v = jnp.clip(transmission if cfg.photon_debug_mode == 3 else metallic, 0.0, 1.0)
        dbg = jnp.stack([v, v, v], axis=-1)
        dbg_on = ((state.depth == 0) & hit_mask)[:, None]
        diff_rad = jnp.where(dbg_on, dbg, diff_rad)
        spec_rad = jnp.where(dbg_on, 0.0, spec_rad)
    rec_vis = jnp.where(hit_mask & ~is_glass, best_vis, 1.0)
    rec_pen = jnp.where(hit_mask & ~is_glass, best_pen, 0.0)
    rec_dist = jnp.where(hit_mask & ~is_glass, best_dist, C.NRD_FP16_MAX)
    hit_distance = jnp.where(hit_mask, hit.t, F32(10000.0))

    # ---- Children (RayGen.hlsl:591-847) ----------------------------------
    can_spawn = hit_mask  # depth < max_bounces already guaranteed by caller
    sample_dummy = jnp.zeros((n, 3), F32)
    if cfg.any_glass:
        entering = front_face
        eta = jnp.where(entering, 1.0 / ior, ior)
        reflect_dir0 = _reflect(state.direction, nrm)
        reflect_dir0 = reflect_dir0 / jnp.maximum(
            jnp.linalg.norm(reflect_dir0, axis=-1, keepdims=True), 1e-12
        )
        refract_dir, tir = _refract(state.direction, nrm, eta)
        refract_dir = jnp.where(
            tir[:, None],
            refract_dir,
            refract_dir
            / jnp.maximum(jnp.linalg.norm(refract_dir, axis=-1, keepdims=True), 1e-12),
        )
        # Roughness perturbation at depth 0 (RayGen.hlsl:613-623)
        rng_reflect = sampling.rng_init(
            px, py, scene.frame_index, sample_idx_rng, C.RNG_SALT_REFLECT
        )
        _, pert_reflect = sampling.perturb_reflection(reflect_dir0, nrm, roughness, rng_reflect)
        rng_refract = sampling.rng_init(
            px, py, scene.frame_index, sample_idx_rng, C.RNG_SALT_REFRACT
        )
        _, pert_refract = sampling.perturb_reflection(refract_dir, -nrm, roughness, rng_refract)
        glass_perturb = (roughness > 0.01) & (state.depth == 0)
        g_reflect = jnp.where(glass_perturb[:, None], pert_reflect, reflect_dir0)
        g_refract = jnp.where((glass_perturb & ~tir)[:, None], pert_refract, refract_dir)

        cos_theta = jnp.clip(jnp.sum(-state.direction * nrm, axis=-1), 0.0, 1.0)
        fresnel = shade.fresnel_schlick(cos_theta, f0_glass)
        fresnel = jnp.where(tir, 1.0, fresnel)
        reflect_tp = jnp.clip(jnp.broadcast_to(fresnel[:, None], (n, 3)), 0.0, 1.0)
        tint = jnp.where(
            entering[:, None],
            1.0 + (albedo - 1.0) * F32(C.GLASS_TINT_STRENGTH),
            jnp.ones((n, 3), F32),
        )
        refract_tp = jnp.clip(
            (1.0 - fresnel)[:, None] * jnp.clip(transmission, 0.0, 1.0)[:, None] * tint, 0.0, 1.0
        )

        # Thickness ray for Beer-Lambert absorption (RayGen.hlsl:646-678).
        # Compiled out when every glass material's absorption is zero: the
        # ray's only consumer is exp(-absorption*thickness) == 1 then.
        glass_spawn = can_spawn & is_glass
        thick_tag = jnp.zeros((n,), I32)
        if cfg.any_absorption:
            th_origin = pos + g_refract * F32(C.SELF_OFFSET)
            do_thickness = glass_spawn & ~tir
            th_type = hit.obj_type
            if scene.mesh is not None:
                # Mesh-glass lanes defer their thickness to the refract
                # child's own closest walk (fused_thick above): tag the
                # child with instance+1 in ray_flags bits 8+. The thickness
                # ray still counts — the reference traces it
                # (RayGen.hlsl:650-670), we just resolve it for free.
                absorbing = jnp.any(absorption > 0.0, axis=-1)
                is_mesh_th = th_type == C.OBJECT_TYPE_MESH
                thick_tag = jnp.where(do_thickness & is_mesh_th & absorbing,
                                      (hit.obj_index + 1) << 8, 0)
                th_type = jnp.where(is_mesh_th, _INVALID, th_type)
            th_hit, th_t = intersect.trace_thickness(
                scene, th_origin, g_refract, th_type, hit.obj_index,
                include_mesh=scene.mesh is None,
            )
            ray_count = ray_count + do_thickness.astype(I32)
            thickness = jnp.where(do_thickness & th_hit, th_t, 0.0)
            refraction_absorb = jnp.where(
                (~tir & (thickness > 0.0))[:, None],
                jnp.exp(-absorption * (thickness * F32(C.GLASS_ABSORPTION_SCALE))[:, None]),
                jnp.ones((n, 3), F32),
            )
        else:
            refraction_absorb = jnp.ones((n, 3), F32)
    else:
        glass_spawn = jnp.zeros((n,), bool)
        thick_tag = jnp.zeros((n,), I32)
        tir = jnp.zeros((n,), bool)
        entering = front_face
        g_reflect = sample_dummy
        g_refract = sample_dummy
        reflect_tp = sample_dummy
        refract_tp = sample_dummy
        refraction_absorb = sample_dummy

    # Metal child (RayGen.hlsl:806-846)
    if cfg.any_metal:
        is_metal = ~is_glass & (metallic > 0.1)
        reflect_m = _reflect(state.direction, nrm)
        rng_metal = sampling.rng_init(
            px, py, scene.frame_index, sample_idx_rng, C.RNG_SALT_REFLECT
        )
        _, metal_dir = sampling.perturb_reflection(reflect_m, nrm, roughness, rng_metal)
        ndotv_m = jnp.clip(jnp.sum(nrm * -state.direction, axis=-1), 0.0, 1.0)
        f_metal = shade.fresnel_schlick3(ndotv_m, f0)
        reflect_scale = 1.0 - roughness * 0.5
        boost = jnp.where(state.depth > 0, F32(C.METAL_SECONDARY_BOOST), F32(1.0))
        metal_tp = f_metal * (reflect_scale * boost)[:, None] * state.throughput
        metal_spawn = can_spawn & is_metal
    else:
        metal_spawn = jnp.zeros((n,), bool)
        metal_dir = sample_dummy
        metal_tp = sample_dummy

    children = {
        "glass_spawn": glass_spawn,
        "metal_spawn": metal_spawn,
        "tir": tir,
        "entering": entering,
        "reflect_dir": g_reflect,
        "refract_dir": g_refract,
        "metal_dir": metal_dir,
        "reflect_tp": reflect_tp * state.throughput,
        "refract_tp": refract_tp * refraction_absorb * state.throughput,
        "metal_tp": metal_tp,
        "hit_pos": pos,
        "normal": nrm,
        "hit_obj_type": hit.obj_type,
        "hit_obj_index": hit.obj_index,
        "thick_tag": thick_tag,
    }
    records = {
        "color": color,
        "diffuse": diff_rad,
        "specular": spec_rad,
        "hit_distance": hit_distance,
        "shadow_vis": rec_vis,
        "shadow_pen": rec_pen,
        "shadow_dist": rec_dist,
        "hit_mask": hit_mask,
        "normal": nrm,
        "roughness": roughness,
        "albedo": albedo,
        "metallic": metallic,
        "transmission": transmission,
        "position": pos,
        "obj_id": jnp.where(
            hit_mask, hit.obj_type * 65536 + hit.obj_index, -1
        ).astype(I32),
    }
    if beer is not None:
        # The caller accumulates contrib = cur.throughput(unscaled) * color,
        # so the deferred Beer rides the radiance (records are depth-0 only
        # and tagged lanes are depth>=1 — they never record).
        color = color * beer
    return color, records, children, ray_count


def run_sample(scene: FlatScene, cfg: RenderConfig, px, py, sample_index, primary: RayState,
               prev_prim_hit):
    """Run the full DFS wavefront for one sample. Returns a SampleAccum."""
    n = px.shape[0]
    zero3 = jnp.zeros((n, 3), F32)
    accum = SampleAccum(
        sample_color=zero3,
        primary_contrib=zero3,
        bounce_count=jnp.zeros((n,), I32),
        rays=jnp.zeros((n,), I32),
        diffuse=zero3,
        specular=zero3,
        hit_dist=jnp.zeros((n,), F32),
        shadow_vis=jnp.ones((n,), F32),
        shadow_pen=jnp.zeros((n,), F32),
        shadow_dist=jnp.full((n,), C.NRD_FP16_MAX, F32),
        prim_hit=jnp.zeros((n,), bool),
        prim_normal=jnp.tile(jnp.array([0.0, 1.0, 0.0], F32), (n, 1)),
        prim_rough=jnp.ones((n,), F32),
        prim_albedo=zero3,
        prim_metallic=jnp.zeros((n,), F32),
        prim_transmission=jnp.zeros((n,), F32),
        prim_pos=zero3,
        prim_obj_id=jnp.full((n,), -1, I32),
    )

    def cond(carry):
        it, cur, stack, acc = carry
        return (it < cfg.max_queue_iters) & jnp.any(cur.valid | (stack.count > 0))

    def body(carry):
        it, cur, stack, acc = carry
        active = cur.valid

        # bounceCount = max(bounceCount, depth+1) (RayGen.hlsl:182)
        bounce_count = jnp.maximum(acc.bounce_count, jnp.where(active, cur.depth + 1, 0))

        # Depth cap -> sky fallback without boost (RayGen.hlsl:184-193)
        capped = active & (cur.depth >= cfg.max_bounces)
        sky_nb = shade.sky_color(cur.direction)
        cap_contrib = cur.throughput * sky_nb
        sample_color = acc.sample_color + jnp.where(capped[:, None], cap_contrib, 0.0)
        primary_contrib = acc.primary_contrib + jnp.where(
            (capped & (cur.depth == 0))[:, None], cap_contrib, 0.0
        )

        # Throughput kill (RayGen.hlsl:195-199)
        killed = (
            active
            & ~capped
            & (_max3(cur.throughput) < C.THROUGHPUT_THRESHOLD)
            & ((cur.flags & C.PATH_FLAG_SPECULAR) == 0)
        )
        traced = active & ~capped & ~killed
        rays = acc.rays + traced.astype(I32)

        color, rec, ch, extra_rays = _shade_and_spawn(
            scene, cfg, px, py, sample_index, cur, traced
        )
        rays = rays + jnp.where(traced, extra_rays, 0)

        contrib = cur.throughput * color
        sample_color = sample_color + jnp.where(traced[:, None], contrib, 0.0)
        primary_contrib = primary_contrib + jnp.where(
            (traced & (cur.depth == 0))[:, None], contrib, 0.0
        )

        # Depth-0 records (RayGen.hlsl:560-589). The primary is always the
        # first processed item, so `traced & depth==0` fires exactly once.
        rec_now = traced & (cur.depth == 0)
        diffuse = acc.diffuse + jnp.where(rec_now[:, None], rec["diffuse"], 0.0)
        specular = acc.specular + jnp.where(rec_now[:, None], rec["specular"], 0.0)
        hit_dist = acc.hit_dist + jnp.where(rec_now, rec["hit_distance"], 0.0)
        shadow_vis = jnp.where(rec_now, rec["shadow_vis"], acc.shadow_vis)
        shadow_pen = jnp.where(rec_now, rec["shadow_pen"], acc.shadow_pen)
        shadow_dist = jnp.where(rec_now, rec["shadow_dist"], acc.shadow_dist)
        first_hit = rec_now & rec["hit_mask"] & ~prev_prim_hit & ~acc.prim_hit
        prim_normal = jnp.where(first_hit[:, None], rec["normal"], acc.prim_normal)
        prim_rough = jnp.where(first_hit, rec["roughness"], acc.prim_rough)
        prim_albedo = jnp.where(first_hit[:, None], rec["albedo"], acc.prim_albedo)
        prim_metallic = jnp.where(first_hit, rec["metallic"], acc.prim_metallic)
        prim_transmission = jnp.where(first_hit, rec["transmission"], acc.prim_transmission)
        prim_pos = jnp.where(first_hit[:, None], rec["position"], acc.prim_pos)
        prim_obj_id = jnp.where(first_hit, rec["obj_id"], acc.prim_obj_id)
        prim_hit = acc.prim_hit | first_hit

        # ---- Continuation / stack update (RayGen.hlsl:697-846) ----------
        qc = stack.count
        glass_spawn = ch["glass_spawn"] & traced
        metal_spawn = ch["metal_spawn"] & traced
        tir = ch["tir"]

        push_reflect = glass_spawn & (qc < STACK_DEPTH)
        qc_after = qc + push_reflect.astype(I32)
        refract_ok = glass_spawn & ~tir & (qc_after < STACK_DEPTH)
        # Reflect stays on the stack only when refract becomes the
        # continuation (LIFO pops refract first otherwise reflect).
        stack_write = push_reflect & refract_ok

        next_depth = cur.depth + 1
        spec_flags = cur.flags | C.PATH_FLAG_SPECULAR
        reflect_child = RayState(
            valid=push_reflect,
            origin=ch["hit_pos"] + ch["normal"] * F32(C.SELF_OFFSET),
            direction=ch["reflect_dir"],
            depth=next_depth,
            throughput=ch["reflect_tp"],
            flags=spec_flags,
            sky_boost=jnp.full((stack.count.shape[0],), C.SKY_BOOST_GLASS, F32),
            ray_flags=jnp.full((stack.count.shape[0],), C.RAYFLAG_SKIP_SELF, I32),
            skip_type=ch["hit_obj_type"],
            skip_index=ch["hit_obj_index"],
        )
        stack = _stack_push(stack, reflect_child, stack_write)

        n_lanes = stack.count.shape[0]
        refract_flags = jnp.where(
            ch["entering"],
            spec_flags | C.PATH_FLAG_INSIDE,
            spec_flags & ~jnp.int32(C.PATH_FLAG_INSIDE),
        )
        refract_child = RayState(
            valid=refract_ok,
            origin=ch["hit_pos"] + ch["refract_dir"] * F32(C.SELF_OFFSET),
            direction=ch["refract_dir"],
            depth=next_depth,
            throughput=ch["refract_tp"],
            flags=refract_flags,
            sky_boost=jnp.full((n_lanes,), C.SKY_BOOST_GLASS, F32),
            # pending-thickness tag (instance+1 in bits 8+) — resolved by
            # the child's own fused closest walk (_shade_and_spawn)
            ray_flags=ch["thick_tag"],
            skip_type=jnp.full((n_lanes,), _INVALID, I32),
            skip_index=jnp.zeros((n_lanes,), I32),
        )

        metal_inside = (spec_flags & C.PATH_FLAG_INSIDE) != 0
        metal_child = RayState(
            valid=metal_spawn,
            origin=ch["hit_pos"] + ch["normal"] * F32(C.SELF_OFFSET),
            direction=ch["metal_dir"],
            depth=next_depth,
            throughput=ch["metal_tp"],
            flags=spec_flags,
            sky_boost=jnp.full((n_lanes,), C.SKY_BOOST_METAL, F32),
            ray_flags=jnp.where(metal_inside, 0, C.RAYFLAG_SKIP_SELF).astype(I32),
            skip_type=jnp.where(metal_inside, _INVALID, ch["hit_obj_type"]),
            skip_index=jnp.where(metal_inside, 0, ch["hit_obj_index"]),
        )

        # Continuation selection: refract > reflect(unpushed) > metal > pop.
        cont_refract = refract_ok
        cont_reflect = push_reflect & ~refract_ok
        cont_metal = metal_spawn

        def pick(field_fn, default):
            v = default
            v = jnp.where(_bmask(cont_metal, v), field_fn(metal_child), v)
            v = jnp.where(_bmask(cont_reflect, v), field_fn(reflect_child), v)
            v = jnp.where(_bmask(cont_refract, v), field_fn(refract_child), v)
            return v

        has_cont = cont_refract | cont_reflect | cont_metal
        empty = _empty_ray(n_lanes)
        cont = RayState(
            valid=has_cont,
            origin=pick(lambda r: r.origin, empty.origin),
            direction=pick(lambda r: r.direction, empty.direction),
            depth=pick(lambda r: r.depth, empty.depth),
            throughput=pick(lambda r: r.throughput, empty.throughput),
            flags=pick(lambda r: r.flags, empty.flags),
            sky_boost=pick(lambda r: r.sky_boost, empty.sky_boost),
            ray_flags=pick(lambda r: r.ray_flags, empty.ray_flags),
            skip_type=pick(lambda r: r.skip_type, empty.skip_type),
            skip_index=pick(lambda r: r.skip_index, empty.skip_index),
        )
        # Terminal lanes pop the deferred sibling.
        stack, popped_ray, popped = _stack_pop(stack, ~has_cont)
        cur_next = RayState(
            valid=has_cont | popped,
            origin=jnp.where(popped[:, None], popped_ray.origin, cont.origin),
            direction=jnp.where(popped[:, None], popped_ray.direction, cont.direction),
            depth=jnp.where(popped, popped_ray.depth, cont.depth),
            throughput=jnp.where(popped[:, None], popped_ray.throughput, cont.throughput),
            flags=jnp.where(popped, popped_ray.flags, cont.flags),
            sky_boost=jnp.where(popped, popped_ray.sky_boost, cont.sky_boost),
            ray_flags=jnp.where(popped, popped_ray.ray_flags, cont.ray_flags),
            skip_type=jnp.where(popped, popped_ray.skip_type, cont.skip_type),
            skip_index=jnp.where(popped, popped_ray.skip_index, cont.skip_index),
        )

        acc_next = SampleAccum(
            sample_color=sample_color,
            primary_contrib=primary_contrib,
            bounce_count=bounce_count,
            rays=rays,
            diffuse=diffuse,
            specular=specular,
            hit_dist=hit_dist,
            shadow_vis=shadow_vis,
            shadow_pen=shadow_pen,
            shadow_dist=shadow_dist,
            prim_hit=prim_hit,
            prim_normal=prim_normal,
            prim_rough=prim_rough,
            prim_albedo=prim_albedo,
            prim_metallic=prim_metallic,
            prim_transmission=prim_transmission,
            prim_pos=prim_pos,
            prim_obj_id=prim_obj_id,
        )
        return it + 1, cur_next, stack, acc_next

    _, _, _, accum = jax.lax.while_loop(
        cond, body, (jnp.int32(0), primary, _empty_stack(n), accum)
    )
    return accum


def _bmask(mask, template):
    """Broadcast a [N] bool mask against a [N]- or [N,3]-shaped template."""
    if template.ndim == 2:
        return mask[:, None]
    return mask
