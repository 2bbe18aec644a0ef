"""Photon-mapped caustics: emit, trace, sorted spatial hash, gather.

Data-parallel reformulation of the reference photon subsystem
(src/Shader/PhotonEmit.hlsl, PhotonTrace.hlsl, BuildPhotonHash.hlsl,
DXRPipeline.cpp:3511-3676). Photons are a flat SoA batch: emission and the
4-bounce trace are fully vectorized (the reference spawns at most one child
per bounce, so the per-photon queue degenerates to an iterative loop).
Storage replaces `InterlockedAdd` scatter with sort-based binning: photons
sort by their spatial-hash cell and cells address contiguous ranges via
searchsorted — lossless, unlike the reference's 64-slot cells
(BuildPhotonHash.hlsl:96-104).

Like the reference, the pass is disabled by default
(DXRPipeline.h:487 `causticsEnabled = false`) and photons interact with the
analytic primitives only (the photon RTPSO has no triangle hit group).
Gathering happens at primary diffuse hits with corner-cell culling, a
32-photon early-out and a Gaussian kernel (Common.hlsli:887-967).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from . import intersect, sampling

F32 = jnp.float32
I32 = jnp.int32
U32 = jnp.uint32


class PhotonMap(NamedTuple):
    """Sorted photon storage + spatial hash ranges (a jax pytree)."""

    position: jnp.ndarray  # [P,3]
    direction: jnp.ndarray  # [P,3] incoming direction
    color: jnp.ndarray  # [P,3]
    power: jnp.ndarray  # [P]
    valid: jnp.ndarray  # [P] bool
    cell_start: jnp.ndarray  # [HASH_SIZE] first sorted index of cell
    cell_count: jnp.ndarray  # [HASH_SIZE]
    count: jnp.ndarray  # scalar i32 number of stored photons
    radius: jnp.ndarray  # scalar gather radius
    intensity: jnp.ndarray  # scalar caustic intensity


def _random_float(seed):
    """RandomFloat (Common.hlsli:833-837): PcgHash state advance."""
    seed = sampling.pcg_hash(seed)
    return seed, (seed >> U32(8)).astype(F32) * F32(1.0 / 16777216.0)


def hash_cell(cell_x, cell_y, cell_z):
    """HashPhotonCell (Common.hlsli:877-883); cells are i32."""
    h = (
        (cell_x.astype(U32) * U32(73856093))
        ^ (cell_y.astype(U32) * U32(19349663))
        ^ (cell_z.astype(U32) * U32(83492791))
    )
    return (h % U32(C.PHOTON_HASH_TABLE_SIZE)).astype(I32)


def photon_budget(scene_data) -> int:
    """Photon count with the reference's TDR caps (DXRPipeline.cpp:3596-3633)."""
    from ..scene.data import LightType

    lights = scene_data.lights
    non_ambient = sum(1 for l in lights if l.type != LightType.AMBIENT)
    point = sum(1 for l in lights if l.type == LightType.POINT)
    objects = len(scene_data.objects)
    has_specular = any(
        getattr(o, "material", None) is not None
        and (o.material.transmission > 0.01 or o.material.metallic > 0.5)
        for o in scene_data.objects
    )
    if not has_specular or non_ambient == 0:
        return 0
    total = 32768 * non_ambient
    total = min(total, C.MAX_PHOTONS)
    if point > 0:
        total = min(total, 8192 * max(1, non_ambient))
    safe_cap = 131072
    if point > 0 and objects > 1:
        safe_cap = min(safe_cap, 65536)
    return min(total, safe_cap)


def emit_and_trace(scene, total_photons: int) -> PhotonMap:
    """Emit photons from lights and trace up to MAX_PHOTON_BOUNCES.

    scene: FlatScene (mesh ignored — parity with the photon RTPSO).
    """
    stores = trace_photon_slice(scene, total_photons, 0, total_photons)
    return build_photon_hash(*stores)


def trace_photon_slice(scene, total_photons: int, offset, count: int):
    """Emit + trace photons [offset, offset+count) of a total_photons batch.

    The photon axis is embarrassingly parallel (every photon's emission
    and RR chain is keyed on its GLOBAL index, PhotonEmit.hlsl:44-48), so
    a slice traced here is bit-identical to the same rows of the full
    batch — the multi-chip unit: each device traces total/n_dev photons,
    `jax.lax.all_gather(..., tiled=True)` reassembles the global store
    arrays in index order, and build_photon_hash runs replicated
    (parallel/tiles.py). `offset` may be traced (a mesh axis_index).
    Returns (store_pos [count,3], store_dir, store_color, store_power,
    store_mask).
    """
    origin, direction, color, power, alive = _emit_photons(
        scene, total_photons, offset=offset, count=count)
    idx = (jax.lax.broadcasted_iota(I32, (count, 1), 0)[:, 0]
           + jnp.asarray(offset, I32))

    # photon interactions ignore meshes (photon RTPSO has no triangle group)
    pscene = scene._replace(mesh=None) if scene.mesh is not None else scene
    return _trace_photons(pscene, origin, direction, color, power, alive,
                              idx=idx)


def _emit_photons(scene, total_photons: int, offset=0, count: int = None):
    """Photon emission (PhotonEmit.hlsl:44-117): light selection + initial
    rays. Returns (origin, direction, color [P,3], power, alive [P]).

    offset/count select a slice of the global batch: per-photon seeds and
    the light-assignment ordinal are functions of the GLOBAL index, so
    slices compose bit-exactly into the full batch (trace_photon_slice).
    The per-light split (photons_per_light) always uses total_photons.
    """
    n = count if count is not None else total_photons
    l_cap = scene.lt_type.shape[0]
    idx = (jax.lax.broadcasted_iota(I32, (n, 1), 0)[:, 0]
           + jnp.asarray(offset, I32))
    seed = sampling.wang_hash(idx.astype(U32) * U32(1973) + U32(9277))

    # Light selection (PhotonEmit.hlsl:48-82): photons split evenly over
    # non-ambient lights in light-index order.
    non_ambient = jnp.zeros((), I32)
    for li in range(l_cap):
        lv = (li < scene.num_lights) & scene.lt_valid[li]
        non_ambient = non_ambient + (lv & (scene.lt_type[li] != C.LIGHT_TYPE_AMBIENT)).astype(I32)
    photons_per_light = jnp.maximum(total_photons // jnp.maximum(non_ambient, 1), 1)
    ordinal = jnp.minimum(idx // photons_per_light, jnp.maximum(non_ambient - 1, 0))

    # map ordinal -> actual light index, gathering parameters
    lt_type = jnp.zeros((n,), I32)
    lt_pos = jnp.zeros((n, 3), F32)
    lt_color = jnp.ones((n, 3), F32)
    lt_intensity = jnp.ones((n,), F32)
    running = jnp.zeros((), I32)
    for li in range(l_cap):
        lv = (li < scene.num_lights) & scene.lt_valid[li]
        na = lv & (scene.lt_type[li] != C.LIGHT_TYPE_AMBIENT)
        sel = na & (ordinal == running)
        lt_type = jnp.where(sel, scene.lt_type[li], lt_type)
        lt_pos = jnp.where(sel[:, None], scene.lt_position[li][None, :], lt_pos)
        lt_color = jnp.where(sel[:, None], scene.lt_color[li][None, :3], lt_color)
        lt_intensity = jnp.where(sel, scene.lt_intensity[li], lt_intensity)
        running = running + na.astype(I32)

    color = lt_color * lt_intensity[:, None]
    power = lt_intensity / photons_per_light.astype(F32)

    # Point: emit from position over the sphere, power *= 4pi
    # (PhotonEmit.hlsl:90-98)
    seed, z0 = _random_float(seed)
    seed, p0 = _random_float(seed)
    z = z0 * 2.0 - 1.0
    phi = p0 * F32(6.28318530718)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    sphere_dir = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    is_point = lt_type == C.LIGHT_TYPE_POINT
    is_dir = lt_type == C.LIGHT_TYPE_DIRECTIONAL
    power = jnp.where(is_point, power * F32(4.0 * 3.14159265), power)

    # Directional: virtual emitter plane 20 units wide, 50 back
    # (PhotonEmit.hlsl:99-117). Uses the same two randoms (the reference
    # consumes 2 randoms on both paths before tracing).
    ldir = -lt_pos
    ldir = ldir / jnp.maximum(jnp.linalg.norm(ldir, axis=-1, keepdims=True), 1e-12)
    up = jnp.where(
        jnp.abs(ldir[:, 1:2]) < 0.999,
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], F32), ldir.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], F32), ldir.shape),
    )
    right = jnp.cross(up, ldir)
    right = right / jnp.maximum(jnp.linalg.norm(right, axis=-1, keepdims=True), 1e-12)
    real_up = jnp.cross(ldir, right)
    off_x = (z0 * 2.0 - 1.0) * 20.0
    off_y = (p0 * 2.0 - 1.0) * 20.0
    plane_origin = right * off_x[:, None] + real_up * off_y[:, None] - ldir * 50.0

    origin = jnp.where(is_point[:, None], lt_pos, plane_origin)
    direction = jnp.where(is_point[:, None], sphere_dir, ldir)
    alive = is_point | is_dir
    return origin, direction, color, power, alive


def _trace_photons(pscene, origin, direction, color, power, alive,
                   idx=None):
    """The photon bounce loop (PhotonTrace.hlsl:97-223), vectorized.

    `idx` is each photon's GLOBAL batch index (RR seeding key); defaults
    to 0..n-1 for a full batch.
    """
    n = origin.shape[0]
    if idx is None:
        idx = jax.lax.broadcasted_iota(I32, (n, 1), 0)[:, 0]

    store_mask = jnp.zeros((n,), bool)
    store_pos = jnp.zeros((n, 3), F32)
    store_dir = jnp.zeros((n, 3), F32)
    store_color = jnp.zeros((n, 3), F32)
    store_power = jnp.zeros((n,), F32)
    is_caustic = jnp.zeros((n,), bool)

    tmin = jnp.full((n,), C.RAY_TMIN, F32)
    tmax = jnp.full((n,), C.RAY_TMAX, F32)
    for _depth in range(C.MAX_PHOTON_BOUNCES):
        hit = intersect.trace_closest(pscene, origin, direction, tmin, tmax)
        live_hit = alive & hit.hit
        pos = origin + direction * hit.t[:, None]
        # intersection-shader normal: outward for spheres/planes; boxes
        # report the slab normal but every use below is sign-invariant
        _, n_faced, front = intersect.surface_normal(pscene, hit, origin, direction)
        normal = jnp.where(front[:, None], n_faced, -n_faced)  # outward

        slot = hit.mat_slot
        mat_rgb = pscene.mat_color[slot][:, :3]
        metallic = pscene.mat_metallic[slot]
        transmission = pscene.mat_transmission[slot]
        roughness = pscene.mat_roughness[slot]
        ior = pscene.mat_ior[slot]

        # Russian roulette seeded per (photon, depth). The reference hashes
        # the hit position's float BITS (PhotonTrace.hlsl:97-108) purely as
        # an entropy source; keying on the photon index is statistically
        # identical but invariant to ulp-level intersection differences, so
        # photon fates agree across backends and device counts.
        rr_seed = sampling.wang_hash(
            idx.astype(U32) * U32(9781) ^ (U32(_depth) * U32(0x9E3779B9))
        )
        rr_seed, rr = _random_float(rr_seed)
        survival = jnp.clip(jnp.max(mat_rgb, axis=-1), 0.1, 0.95)
        survive = rr <= survival
        power = jnp.where(live_hit, power / survival, power)
        color = jnp.where(live_hit[:, None], color * mat_rgb, color)
        alive = alive & hit.hit & survive

        is_glass = transmission > 0.5
        is_metal = ~is_glass & (metallic > 0.5)
        is_diffuse = ~is_glass & ~is_metal

        # Diffuse: store if caustic, terminate (PhotonTrace.hlsl:117-128)
        store_now = alive & is_diffuse & is_caustic & ~store_mask
        store_mask = store_mask | store_now
        store_pos = jnp.where(store_now[:, None], pos, store_pos)
        store_dir = jnp.where(store_now[:, None], direction, store_dir)
        store_color = jnp.where(store_now[:, None], color, store_color)
        store_power = jnp.where(store_now, power, store_power)
        alive = alive & ~is_diffuse

        # Glass: probabilistic Fresnel reflect/refract (PhotonTrace.hlsl:129-190)
        view = -direction
        front2 = jnp.sum(view * normal, axis=-1) > 0.0
        outward = jnp.where(front2[:, None], normal, -normal)
        cos_theta = jnp.abs(jnp.sum(view * outward, axis=-1))
        f0 = jnp.square((1.0 - ior) / (1.0 + ior))
        # explicit x^5
        om = 1.0 - cos_theta
        om2 = om * om
        fresnel = f0 + (1.0 - f0) * (om2 * om2 * om)
        rr_seed, choice = _random_float(rr_seed)
        refracting = choice > fresnel
        eta = jnp.where(front2, 1.0 / ior, ior)
        cosi = -jnp.sum(direction * outward, axis=-1)
        sin2t = eta * eta * (1.0 - cosi * cosi)
        tir = sin2t > 1.0
        cost = jnp.sqrt(jnp.maximum(1.0 - sin2t, 0.0))
        refr = eta[:, None] * direction + (eta * cosi - cost)[:, None] * outward
        refl = direction - 2.0 * jnp.sum(direction * outward, axis=-1, keepdims=True) * outward
        refr_norm = refr / jnp.maximum(jnp.linalg.norm(refr, axis=-1, keepdims=True), 1e-12)
        glass_dir = jnp.where(
            (refracting & ~tir)[:, None], refr_norm, refl
        )
        glass_origin = jnp.where(
            (refracting & ~tir)[:, None], pos - outward * 0.01, pos + outward * 0.01
        )

        # Metal: roughness-lerped reflection (PhotonTrace.hlsl:191-223)
        refl_m = direction - 2.0 * jnp.sum(direction * normal, axis=-1, keepdims=True) * normal
        rr_seed, hz = _random_float(rr_seed)
        rr_seed, hphi = _random_float(rr_seed)
        hz2 = hz * 2.0 - 1.0
        hr = jnp.sqrt(jnp.maximum(0.0, 1.0 - hz2 * hz2))
        hemi = jnp.stack(
            [hr * jnp.cos(hphi * F32(6.28318530718)),
             hr * jnp.sin(hphi * F32(6.28318530718)), hz2], axis=-1
        )
        hemi = jnp.where(
            jnp.sum(hemi * normal, axis=-1, keepdims=True) > 0.0, hemi, -hemi
        )
        rough2 = (roughness * roughness)[:, None]
        metal_dir = refl_m + (hemi - refl_m) * rough2
        metal_dir = jnp.where(
            (roughness > 0.01)[:, None],
            metal_dir / jnp.maximum(jnp.linalg.norm(metal_dir, axis=-1, keepdims=True), 1e-12),
            refl_m,
        )

        is_caustic = is_caustic | (alive & (is_glass | is_metal))
        origin = jnp.where(
            is_glass[:, None], glass_origin, pos + normal * 0.01
        )
        direction = jnp.where(is_glass[:, None], glass_dir, metal_dir)

    return store_pos, store_dir, store_color, store_power, store_mask


def build_photon_hash(store_pos, store_dir, store_color, store_power,
                      store_mask) -> PhotonMap:
    """Sort-based spatial hash build (BuildPhotonHash.hlsl:59-105).

    cellSize = 2 * photonRadius (DXRPipeline.cpp:3392-3435)."""
    cell_size = max(_photon_radius() * 2.0, 1e-4)
    cell = jnp.floor(store_pos / cell_size).astype(I32)
    h = hash_cell(cell[:, 0], cell[:, 1], cell[:, 2])
    h = jnp.where(store_mask, h, C.PHOTON_HASH_TABLE_SIZE)  # invalid -> end
    order = jnp.argsort(h)
    h_sorted = h[order]
    count = jnp.sum(store_mask.astype(I32))
    cells = jnp.arange(C.PHOTON_HASH_TABLE_SIZE, dtype=I32)
    cell_start = jnp.searchsorted(h_sorted, cells).astype(I32)
    cell_end = jnp.searchsorted(h_sorted, cells + 1).astype(I32)
    return PhotonMap(
        position=store_pos[order],
        direction=store_dir[order],
        color=store_color[order],
        power=store_power[order],
        valid=store_mask[order],
        cell_start=cell_start,
        cell_count=cell_end - cell_start,
        count=count,
        radius=jnp.asarray(_photon_radius(), F32),
        intensity=jnp.asarray(_caustic_intensity(), F32),
    )


def _photon_radius() -> float:
    return 0.5  # DXRPipeline.h:484


def _caustic_intensity() -> float:
    return 3.0  # DXRPipeline.h:485


def gather(pmap: PhotonMap, position, normal):
    """GatherPhotons (Common.hlsli:887-967): 19-cell search, Gaussian kernel.

    position/normal: [N,3]. Returns caustic color [N,3].
    """
    n = position.shape[0]
    radius = pmap.radius
    radius_sq = radius * radius
    cell_size = jnp.maximum(radius * 2.0, 1e-4)
    base = jnp.floor(position / cell_size).astype(I32)

    # neighbor cells with corner culling (cellDistSq > 2 skipped)
    offsets = []
    for z in (-1, 0, 1):
        for y in (-1, 0, 1):
            for x in (-1, 0, 1):
                if x * x + y * y + z * z <= 2:
                    offsets.append((x, y, z))
    n_cells = len(offsets)  # 19

    starts = []
    counts = []
    for (x, y, z) in offsets:
        ch = hash_cell(base[:, 0] + x, base[:, 1] + y, base[:, 2] + z)
        starts.append(pmap.cell_start[ch])
        counts.append(pmap.cell_count[ch])
    starts = jnp.stack(starts, axis=1)  # [N,19]
    counts = jnp.stack(counts, axis=1)

    max_gather = C.MAX_GATHER_PHOTONS_THRESHOLD
    cell_scan_cap = C.MAX_PHOTONS_PER_CELL  # parity with the 64-slot cells

    def cond(carry):
        step, cell_i, off, gathered, caustic, weight = carry
        return (step < n_cells * cell_scan_cap + n_cells) & jnp.any(cell_i < n_cells)

    def body(carry):
        step, cell_i, off, gathered, caustic, weight = carry
        in_range = cell_i < n_cells
        ci = jnp.clip(cell_i, 0, n_cells - 1)
        cnt = jnp.minimum(jnp.take_along_axis(counts, ci[:, None], axis=1)[:, 0],
                          cell_scan_cap)
        st = jnp.take_along_axis(starts, ci[:, None], axis=1)[:, 0]
        have = in_range & (off < cnt)
        pi = jnp.clip(st + off, 0, pmap.position.shape[0] - 1)
        ppos = pmap.position[pi]
        pdir = pmap.direction[pi]
        pcol = pmap.color[pi]
        ppow = pmap.power[pi]
        pval = pmap.valid[pi] & (pi < pmap.count)
        diff = position - ppos
        dist_sq = jnp.sum(diff * diff, axis=-1)
        dot_n = jnp.sum(-pdir * normal, axis=-1)
        accept = have & pval & (dist_sq < radius_sq) & (dot_n > 0.0)
        w = jnp.exp(-dist_sq / (2.0 * radius_sq * 0.5)) * dot_n
        caustic = caustic + jnp.where(accept[:, None], pcol * (ppow * w)[:, None], 0.0)
        weight = weight + jnp.where(accept, w, 0.0)
        gathered = gathered + accept.astype(I32)
        # advance: next photon in the cell, or the next cell; early-out once
        # max_gather photons were accepted (Common.hlsli:902-917)
        next_off = off + 1
        move_cell = in_range & (next_off >= cnt)
        cell_i = jnp.where(gathered >= max_gather, n_cells, cell_i + move_cell.astype(I32))
        off = jnp.where(move_cell, 0, next_off)
        return step + 1, cell_i, off, gathered, caustic, weight

    init = (
        jnp.int32(0),
        jnp.zeros((n,), I32),
        jnp.zeros((n,), I32),
        jnp.zeros((n,), I32),
        jnp.zeros((n, 3), F32),
        jnp.zeros((n,), F32),
    )
    _, _, _, _, caustic, weight = jax.lax.while_loop(cond, body, init)
    area = F32(3.14159265) * radius_sq
    caustic = jnp.where((weight > 0.0)[:, None], caustic / area, 0.0)
    return caustic * pmap.intensity
