"""Batched analytic primitive intersection.

Vectorized (rays x primitives) equivalents of the reference's DXR
intersection shader (src/Shader/Intersection.hlsl:17-198): analytic sphere
quadratic, infinite plane, and OBB slab tests, plus the closest-hit resolve
that DXR's traversal performs in hardware. Self-intersection rejection
matches AnyHit_SkipSelf (src/Shader/AnyHit_SkipSelf.hlsl:6-28), shadow
transmission accumulation matches AnyHit_Shadow
(src/Shader/AnyHit_Shadow.hlsl:10-57), and the same-object thickness query
matches AnyHit_Thickness (:91-108).

All functions take a FlatScene and ray SoA arrays of shape [N,3]/[N] and
return per-ray results; the primitive axis is reduced on-device.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C

# Python scalars (not jnp constants): creating device arrays at import time
# would initialize the default backend before callers can pick one.
_BIG = 1e30
_INF = 1e20  # matches Intersection.hlsl:102
_EPS = 1e-6


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


# OBB frame changes run at full float32 precision: the default precision may
# contract float32 einsums in TF32 on GPUs, which moves box hits and normals.
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def intersect_spheres(origin, direction, tmin, tmax, centers, radii, valid):
    """Sphere quadratic (Intersection.hlsl:17-52).

    origin/direction: [N,3]; centers [S,3]; radii/valid [S].
    Returns t [N,S] (1e30 where miss).
    """
    oc = origin[:, None, :] - centers[None, :, :]  # [N,S,3]
    a = _dot(direction, direction)[:, None]  # [N,1]
    b = 2.0 * jnp.sum(oc * direction[:, None, :], axis=-1)  # [N,S]
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = b * b - 4.0 * a * c
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sqrt_d) / (2.0 * a)
    t2 = (-b + sqrt_d) / (2.0 * a)
    t = jnp.where(t1 < tmin[:, None], t2, t1)
    ok = (disc >= 0.0) & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return jnp.where(ok, t, _BIG)


def intersect_planes(origin, direction, tmin, tmax, positions, normals, valid):
    """Infinite plane (Intersection.hlsl:53-77). Returns t [N,P]."""
    n = normals / jnp.maximum(jnp.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)
    denom = jnp.sum(direction[:, None, :] * n[None, :, :], axis=-1)  # [N,P]
    p0 = positions[None, :, :] - origin[:, None, :]
    t = jnp.sum(p0 * n[None, :, :], axis=-1) / jnp.where(jnp.abs(denom) > 1e-4, denom, 1.0)
    ok = (jnp.abs(denom) > 1e-4) & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return jnp.where(ok, t, _BIG)


def intersect_boxes(origin, direction, tmin, tmax, centers, halves, axes, valid):
    """OBB slab method in local space (Intersection.hlsl:78-198).

    axes: [B,3,3] with rows = box local X/Y/Z axes in world space.
    Returns (t [N,B], entering [N,B]).
    """
    delta = origin[:, None, :] - centers[None, :, :]  # [N,B,3]
    # Project onto local axes: local[k] = dot(v, axes[k])
    lo = _einsum("nbj,bkj->nbk", delta, axes)  # [N,B,3] local origin
    ld = _einsum("nj,bkj->nbk", direction, axes)  # [N,B,3] local dir
    h = halves[None, :, :]  # [1,B,3]

    par = jnp.abs(ld) < _EPS
    par_miss = par & ((lo < -h) | (lo > h))
    inv = 1.0 / jnp.where(par, 1.0, ld)
    t0 = jnp.where(par, -_INF, (-h - lo) * inv)
    t1 = jnp.where(par, _INF, (h - lo) * inv)
    slab_min = jnp.minimum(t0, t1)
    slab_max = jnp.maximum(t0, t1)
    t_near = jnp.max(slab_min, axis=-1)
    t_far = jnp.min(slab_max, axis=-1)

    hit_any = (t_near <= t_far) & (t_far >= tmin[:, None]) & ~jnp.any(par_miss, axis=-1)
    entering = t_near >= tmin[:, None]
    t = jnp.where(entering, t_near, t_far)
    ok = hit_any & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return jnp.where(ok, t, _BIG), entering


class Hit(NamedTuple):
    hit: jnp.ndarray  # [N] bool
    t: jnp.ndarray  # [N]
    obj_type: jnp.ndarray  # [N] i32 (OBJECT_TYPE_*)
    obj_index: jnp.ndarray  # [N] i32 index within type (mesh: instance index)
    mat_slot: jnp.ndarray  # [N] i32 index into the combined material table
    tri: jnp.ndarray = None  # [N] i32 triangle index (mesh hits)
    bary_u: jnp.ndarray = None  # [N]
    bary_v: jnp.ndarray = None  # [N]
    thick_hit: jnp.ndarray = None  # [N] fused same-instance thickness found
    thick_t: jnp.ndarray = None  # [N] its distance


def _apply_skip(t, obj_type, index_base, skip_type, skip_index):
    """AnyHit_SkipSelf: invalidate the (type,index) the payload asks to skip."""
    k = t.shape[1]
    idx = jnp.arange(k, dtype=jnp.int32)[None, :]
    skip = (skip_type[:, None] == obj_type) & (skip_index[:, None] == idx)
    return jnp.where(skip, _BIG, t)


def trace_closest(scene, origin, direction, tmin, tmax, skip_type=None, skip_index=None,
                  thick_inst=None) -> Hit:
    """Closest-hit resolve over spheres ++ planes ++ boxes.

    Global primitive ordering matches the reference's procedural BLAS
    (AccelerationStructure.cpp:107-300), so mat_slot = global index.
    skip_type/skip_index implement RAYFLAG_SKIP_SELF when given.
    thick_inst rides the mesh walk for deferred same-instance thickness
    (bvh.traverse_closest).
    """
    n = origin.shape[0]
    if skip_type is None:
        skip_type = jnp.full((n,), C.OBJECT_TYPE_INVALID & 0x7FFFFFFF, jnp.int32)
        skip_index = jnp.zeros((n,), jnp.int32)

    s_cap = scene.sphere_capacity
    p_cap = scene.plane_capacity
    b_cap = scene.box_capacity
    if s_cap + p_cap + b_cap == 0 and scene.mesh is None:
        miss = jnp.zeros((n,), bool)
        return Hit(
            hit=miss,
            t=jnp.full((n,), _BIG, jnp.float32),
            obj_type=jnp.full((n,), C.OBJECT_TYPE_INVALID & 0x7FFFFFFF, jnp.int32),
            obj_index=jnp.zeros((n,), jnp.int32),
            mat_slot=jnp.zeros((n,), jnp.int32),
            tri=jnp.zeros((n,), jnp.int32),
            bary_u=jnp.zeros((n,), jnp.float32),
            bary_v=jnp.zeros((n,), jnp.float32),
        )

    parts = []
    if s_cap:
        ts = intersect_spheres(
            origin, direction, tmin, tmax, scene.sph_center, scene.sph_radius, scene.sph_valid
        )
        parts.append(_apply_skip(ts, C.OBJECT_TYPE_SPHERE, 0, skip_type, skip_index))
    if p_cap:
        tp = intersect_planes(
            origin, direction, tmin, tmax, scene.pln_position, scene.pln_normal, scene.pln_valid
        )
        parts.append(_apply_skip(tp, C.OBJECT_TYPE_PLANE, 0, skip_type, skip_index))
    if b_cap:
        tb, _ = intersect_boxes(
            origin, direction, tmin, tmax, scene.box_center, scene.box_half, scene.box_axes,
            scene.box_valid,
        )
        parts.append(_apply_skip(tb, C.OBJECT_TYPE_BOX, 0, skip_type, skip_index))
    if parts:
        all_t = jnp.concatenate(parts, axis=1)  # [N, S+P+B]
        best = jnp.argmin(all_t, axis=1).astype(jnp.int32)
        t = jnp.take_along_axis(all_t, best[:, None], axis=1)[:, 0]
    else:
        best = jnp.zeros((n,), jnp.int32)
        t = jnp.full((n,), _BIG, jnp.float32)
    hit = t < _BIG * 0.5

    is_plane = (best >= s_cap) & (best < s_cap + p_cap)
    is_box = best >= s_cap + p_cap
    obj_type = jnp.where(
        is_box,
        jnp.int32(C.OBJECT_TYPE_BOX),
        jnp.where(is_plane, jnp.int32(C.OBJECT_TYPE_PLANE), jnp.int32(C.OBJECT_TYPE_SPHERE)),
    )
    obj_type = jnp.where(hit, obj_type, jnp.int32(C.OBJECT_TYPE_INVALID & 0x7FFFFFFF))
    obj_index = jnp.where(
        is_box, best - s_cap - p_cap, jnp.where(is_plane, best - s_cap, best)
    ).astype(jnp.int32)

    tri = jnp.zeros((n,), jnp.int32)
    bary_u = jnp.zeros((n,), jnp.float32)
    bary_v = jnp.zeros((n,), jnp.float32)
    thick_hit = thick_t = None
    if scene.mesh is not None:
        from . import bvh as bvh_mod

        mesh_skip = skip_type == C.OBJECT_TYPE_MESH
        mh = bvh_mod.traverse_closest(
            scene.mesh, origin, direction, tmin, tmax,
            skip_active=mesh_skip, skip_inst=skip_index, thick_inst=thick_inst,
        )
        better = mh.hit & (mh.t < t)
        t = jnp.where(better, mh.t, t)
        hit = hit | better
        obj_type = jnp.where(better, jnp.int32(C.OBJECT_TYPE_MESH), obj_type)
        obj_index = jnp.where(better, mh.inst, obj_index)
        best = jnp.where(better, s_cap + p_cap + b_cap + mh.inst, best)
        tri = jnp.where(better, mh.tri, tri)
        bary_u = jnp.where(better, mh.u, bary_u)
        bary_v = jnp.where(better, mh.v, bary_v)
        thick_hit, thick_t = mh.thick_hit, mh.thick_t
    return Hit(hit=hit, t=t, obj_type=obj_type, obj_index=obj_index, mat_slot=best,
               tri=tri, bary_u=bary_u, bary_v=bary_v,
               thick_hit=thick_hit, thick_t=thick_t)


def box_face_normal(hit_position, centers, halves, axes, index):
    """Box normal recomputed from the hit position (ClosestHit.hlsl:109-124).

    hit_position [N,3]; index [N] selects the box. Returns world normal [N,3].
    """
    c = centers[index]  # [N,3]
    h = jnp.maximum(halves[index], 1e-4)
    ax = axes[index]  # [N,3,3]
    axn = ax / jnp.maximum(jnp.linalg.norm(ax, axis=-1, keepdims=True), 1e-12)
    local = _einsum("nj,nkj->nk", hit_position - c, axn)  # [N,3]
    scaled = jnp.abs(local / h)
    sign = jnp.where(local >= 0.0, 1.0, -1.0)
    x_wins = (scaled[:, 0] >= scaled[:, 1]) & (scaled[:, 0] >= scaled[:, 2])
    y_wins = ~x_wins & (scaled[:, 1] >= scaled[:, 2])
    ln = jnp.stack(
        [
            jnp.where(x_wins, sign[:, 0], 0.0),
            jnp.where(y_wins, sign[:, 1], 0.0),
            jnp.where(~x_wins & ~y_wins, sign[:, 2], 0.0),
        ],
        axis=-1,
    )
    world = _einsum("nk,nkj->nj", ln, axn)
    return world / jnp.maximum(jnp.linalg.norm(world, axis=-1, keepdims=True), 1e-12)


def surface_normal(scene, hit: Hit, origin, direction):
    """Shading normal + front-face flag at the hit.

    Analytic primitives: outward geometric normal flipped to face the ray
    (ClosestHit.hlsl:127-129). Meshes: barycentric smooth normal with the
    geometric face normal deciding front/back (ClosestHit_Triangle.hlsl:
    122-126). Returns (hit_position, faced_normal, front_face).
    """
    pos = origin + direction * hit.t[:, None]
    n = jnp.tile(jnp.array([0.0, 1.0, 0.0], jnp.float32), (pos.shape[0], 1))
    if scene.sphere_capacity:
        # Sphere: normalize(hit - center) (Intersection.hlsl:41-42)
        sc = scene.sph_center[jnp.clip(hit.obj_index, 0, scene.sphere_capacity - 1)]
        n_sph = pos - sc
        n_sph = n_sph / jnp.maximum(jnp.linalg.norm(n_sph, axis=-1, keepdims=True), 1e-12)
        n = jnp.where((hit.obj_type == C.OBJECT_TYPE_SPHERE)[:, None], n_sph, n)
    if scene.plane_capacity:
        # Plane: normalized plane normal (Intersection.hlsl:59)
        pn = scene.pln_normal[jnp.clip(hit.obj_index, 0, scene.plane_capacity - 1)]
        n_pln = pn / jnp.maximum(jnp.linalg.norm(pn, axis=-1, keepdims=True), 1e-12)
        n = jnp.where((hit.obj_type == C.OBJECT_TYPE_PLANE)[:, None], n_pln, n)
    if scene.box_capacity:
        # Box: recomputed face normal (ClosestHit.hlsl:109-124)
        n_box = box_face_normal(
            pos, scene.box_center, scene.box_half, scene.box_axes,
            jnp.clip(hit.obj_index, 0, scene.box_capacity - 1),
        )
        n = jnp.where((hit.obj_type == C.OBJECT_TYPE_BOX)[:, None], n_box, n)
    front_face = jnp.sum(direction * n, axis=-1) < 0.0
    faced = jnp.where(front_face[:, None], n, -n)
    if scene.mesh is not None:
        from . import bvh as bvh_mod

        tri_hit = bvh_mod.TriHit(
            hit=hit.obj_type == C.OBJECT_TYPE_MESH, t=hit.t, tri=hit.tri,
            u=hit.bary_u, v=hit.bary_v, inst=hit.obj_index,
        )
        smooth, front_geo = bvh_mod.shading_normal(scene.mesh, tri_hit, direction)
        n_mesh = jnp.where(front_geo[:, None], smooth, -smooth)
        is_mesh = hit.obj_type == C.OBJECT_TYPE_MESH
        faced = jnp.where(is_mesh[:, None], n_mesh, faced)
        front_face = jnp.where(is_mesh, front_geo, front_face)
    return pos, faced, front_face


def trace_shadow(scene, origin, direction, max_dist):
    """Shadow transmission along a segment (AnyHit_Shadow.hlsl:10-57).

    Any opaque (transmission < 0.01) primitive hit blocks fully; translucent
    hits multiply `transmission` into visibility and a Beer-Lambert tint
    exp(-sigmaA * SHADOW_ABSORPTION_THICKNESS * ShadowAbsorptionScale) into
    the shadow color. Each primitive contributes at most one intersection,
    like the reference's one-report-per-primitive intersection shader.

    Returns (visibility [N], shadow_color [N,3], occluder_distance [N]).
    """
    n = origin.shape[0]
    tmin = jnp.full((n,), C.RAY_TMIN, jnp.float32)
    if scene.sphere_capacity + scene.plane_capacity + scene.box_capacity == 0:
        vis = jnp.ones((n,), jnp.float32)
        color = jnp.ones((n, 3), jnp.float32)
        occ = jnp.full((n,), C.NRD_FP16_MAX, jnp.float32)
        return _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color, occ)
    parts = []
    if scene.sphere_capacity:
        parts.append(intersect_spheres(
            origin, direction, tmin, max_dist, scene.sph_center, scene.sph_radius,
            scene.sph_valid,
        ))
    if scene.plane_capacity:
        parts.append(intersect_planes(
            origin, direction, tmin, max_dist, scene.pln_position, scene.pln_normal,
            scene.pln_valid,
        ))
    if scene.box_capacity:
        tb, _ = intersect_boxes(
            origin, direction, tmin, max_dist, scene.box_center, scene.box_half,
            scene.box_axes, scene.box_valid,
        )
        parts.append(tb)
    all_t = jnp.concatenate(parts, axis=1)  # [N,M]
    hit_mask = all_t < _BIG * 0.5

    # The combined material table is spheres ++ planes ++ boxes ++ mesh
    # instances (scene/flatten.py m_cap); only the analytic prefix pairs
    # with `all_t` here — instance shadowing folds in via
    # _merge_mesh_shadow below.
    n_analytic = all_t.shape[1]
    transmission = scene.mat_transmission[None, :n_analytic]  # [1,M]
    absorption = scene.mat_absorption[None, :n_analytic, :]  # [1,M,3]
    opaque = hit_mask & (transmission < 0.01)
    blocked = jnp.any(opaque, axis=1)

    translucent = hit_mask & (transmission >= 0.01)
    vis = jnp.prod(jnp.where(translucent, transmission, 1.0), axis=1)
    beer = jnp.exp(
        -absorption
        * jnp.float32(C.SHADOW_ABSORPTION_THICKNESS)
        * scene.shadow_absorption_scale
    )
    has_absorb = jnp.any(absorption > 0.0, axis=-1)  # [1,M]
    beer = jnp.where(has_absorb[..., None], beer, 1.0)
    color = jnp.prod(jnp.where(translucent[..., None], beer, 1.0), axis=1)

    vis = jnp.where(blocked, 0.0, vis)
    color = jnp.where(blocked[:, None], 0.0, color)
    occluder = jnp.min(jnp.where(hit_mask, all_t, jnp.float32(C.NRD_FP16_MAX)), axis=1)
    occluder = jnp.where(jnp.any(hit_mask, axis=1), occluder, jnp.float32(C.NRD_FP16_MAX))
    return _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color,
                              occluder, blocked=blocked)


def _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color, occluder,
                       blocked=None):
    """Fold mesh-instance shadow transmission into the analytic result.

    `blocked` lanes ended their search on an opaque analytic hit
    (AcceptHitAndEndSearch, AnyHit_Shadow.hlsl:44-49) — the mesh walk is
    seeded blocked for them."""
    if scene.mesh is None:
        return vis, color, occluder
    from . import bvh as bvh_mod

    scale = jnp.float32(C.SHADOW_ABSORPTION_THICKNESS) * scene.shadow_absorption_scale
    mvis, mcolor, mocc = bvh_mod.traverse_shadow(
        scene.mesh, origin, direction, max_dist, absorb_scale=scale,
        blocked0=blocked,
    )
    return vis * mvis, color * mcolor, jnp.minimum(occluder, mocc)


def trace_thickness(scene, origin, direction, obj_type, obj_index, include_mesh=True):
    """Same-object thickness query (RayGen.hlsl:646-672, AnyHit_Thickness).

    Finds the nearest intersection with the *same* primitive along the
    refraction direction. Returns (hit [N] bool, t [N]).
    include_mesh=False compiles out the mesh walk — callers that defer
    mesh-glass thickness to the refract child's fused closest walk
    (bvh.traverse_closest thick_inst) pass mesh lanes as invalid here.
    """
    n = origin.shape[0]
    tmin = jnp.full((n,), C.RAY_TMIN, jnp.float32)
    tmax = jnp.full((n,), C.NRD_FP16_MAX, jnp.float32)
    t = jnp.full((n,), _BIG, jnp.float32)
    if scene.sphere_capacity:
        ts = intersect_spheres(
            origin, direction, tmin, tmax, scene.sph_center, scene.sph_radius, scene.sph_valid
        )
        idx = jnp.clip(obj_index, 0, ts.shape[1] - 1)
        t_sph = jnp.take_along_axis(ts, idx[:, None], axis=1)[:, 0]
        t = jnp.where(obj_type == C.OBJECT_TYPE_SPHERE, t_sph, t)
    if scene.box_capacity:
        tb, _ = intersect_boxes(
            origin, direction, tmin, tmax, scene.box_center, scene.box_half, scene.box_axes,
            scene.box_valid,
        )
        idxb = jnp.clip(obj_index, 0, tb.shape[1] - 1)
        t_box = jnp.take_along_axis(tb, idxb[:, None], axis=1)[:, 0]
        t = jnp.where(obj_type == C.OBJECT_TYPE_BOX, t_box, t)
    hit = (t < _BIG * 0.5) & (
        (obj_type == C.OBJECT_TYPE_SPHERE) | (obj_type == C.OBJECT_TYPE_BOX)
    )
    t = jnp.where(hit, t, jnp.float32(C.NRD_FP16_MAX))
    if include_mesh and scene.mesh is not None:
        from . import bvh as bvh_mod

        mh, mt = bvh_mod.traverse_thickness(scene.mesh, origin, direction, obj_index)
        is_mesh = obj_type == C.OBJECT_TYPE_MESH
        hit = jnp.where(is_mesh, mh, hit)
        t = jnp.where(is_mesh, mt, t)
    return hit, t
