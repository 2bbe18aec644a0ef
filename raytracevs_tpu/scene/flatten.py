"""SceneData -> FlatScene device arrays.

Host-side replacement for DXRPipeline::UpdateSceneData
(src/RayTraceVS.DXEngine/DXRPipeline.cpp:709-1270): instead of filling upload
heaps with AoS GPU structs, the scene becomes a pytree of padded SoA
``jnp`` arrays with validity masks (static capacities so jit never sees a
shape change when objects are added within capacity).

Primitive index convention matches the reference's procedural BLAS ordering
(AccelerationStructure.cpp:107-300): global primitive index =
spheres ++ planes ++ boxes; the combined material table is indexed the same
way so a hit's (type, index) resolves materials with one gather.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from .. import constants as C
from .data import LightType, SceneData


def _pad_capacity(n: int, minimum: int) -> int:
    """Next power-of-two capacity >= n, at least `minimum`; 0 stays 0.

    Zero-size primitive arrays compile to nothing, so a scene without boxes
    pays no box-intersection cost (like a DXR BLAS that is simply absent).
    """
    if n == 0:
        return 0
    cap = max(1, minimum)
    while cap < n:
        cap *= 2
    return cap


class FlatScene(NamedTuple):
    """Padded SoA scene arrays (a jax pytree)."""

    # Spheres (SphereData, Common.hlsli:302-319)
    sph_center: jnp.ndarray  # [S,3]
    sph_radius: jnp.ndarray  # [S]
    sph_valid: jnp.ndarray  # [S] bool
    # Planes (Common.hlsli:322-337)
    pln_position: jnp.ndarray  # [P,3]
    pln_normal: jnp.ndarray  # [P,3]
    pln_valid: jnp.ndarray  # [P]
    # Boxes / OBB (Common.hlsli:340-367)
    box_center: jnp.ndarray  # [B,3]
    box_half: jnp.ndarray  # [B,3] half extents
    box_axes: jnp.ndarray  # [B,3,3] rows = axisX/axisY/axisZ in world space
    box_valid: jnp.ndarray  # [B]
    # Combined material table, indexed spheres ++ planes ++ boxes [M=S+P+B]
    mat_color: jnp.ndarray  # [M,4]
    mat_metallic: jnp.ndarray  # [M]
    mat_roughness: jnp.ndarray  # [M]
    mat_transmission: jnp.ndarray  # [M]
    mat_ior: jnp.ndarray  # [M]
    mat_specular: jnp.ndarray  # [M]
    mat_emission: jnp.ndarray  # [M,3]
    mat_absorption: jnp.ndarray  # [M,3]
    # Lights (LightData, Common.hlsli:370-379); directional stores direction
    # in the position slot (SceneEvaluator.cs:411-436)
    lt_type: jnp.ndarray  # [L] i32
    lt_position: jnp.ndarray  # [L,3]
    lt_color: jnp.ndarray  # [L,4]
    lt_intensity: jnp.ndarray  # [L]
    lt_radius: jnp.ndarray  # [L]
    lt_samples: jnp.ndarray  # [L] (clamped to 1 like DXRPipeline.cpp:928)
    lt_valid: jnp.ndarray  # [L]
    num_lights: jnp.ndarray  # i32 scalar
    # Camera basis (DXRPipeline.cpp:730-766)
    cam_pos: jnp.ndarray  # [3]
    cam_forward: jnp.ndarray  # [3]
    cam_right: jnp.ndarray  # [3]
    cam_up: jnp.ndarray  # [3]
    tan_half_fov: jnp.ndarray  # scalar
    aperture_size: jnp.ndarray  # scalar
    focus_distance: jnp.ndarray  # scalar
    # Scene-carried render parameters (traced; SceneConstantBuffer fields)
    exposure: jnp.ndarray
    tone_map_operator: jnp.ndarray  # i32: 0 Reinhard, 1 ACES, 2 None
    shadow_strength: jnp.ndarray
    shadow_absorption_scale: jnp.ndarray
    gamma: jnp.ndarray
    atten_const: jnp.ndarray
    atten_linear: jnp.ndarray
    atten_quadratic: jnp.ndarray
    max_shadow_lights: jnp.ndarray  # i32
    nrd_bypass_distance: jnp.ndarray  # distance-based NRD bypass (Composite.hlsl:425-449)
    nrd_bypass_blend: jnp.ndarray
    frame_index: jnp.ndarray  # u32
    # Row-vector view-projection matrices for motion vectors
    # (DXRPipeline.cpp:794-804; LookAtLH/PerspectiveFovLH, Camera.cpp:26-40)
    view_proj: jnp.ndarray  # [4,4]
    prev_view_proj: jnp.ndarray  # [4,4]
    # Triangle meshes: combined world-space BVH over all instances
    # (None when the scene has no mesh instances); material slots for
    # instance i live at sphere_cap+plane_cap+box_cap+i in the mat table.
    mesh: object = None  # Optional[ops.bvh.MeshArrays]

    @property
    def sphere_capacity(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def plane_capacity(self) -> int:
        return self.pln_normal.shape[0]

    @property
    def box_capacity(self) -> int:
        return self.box_half.shape[0]

    @property
    def light_capacity(self) -> int:
        return self.lt_type.shape[0]


class RenderConfig(NamedTuple):
    """Static (hashable) render configuration — changes recompile, like a PSO swap."""

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 1  # effective, after the ray-budget cap
    max_bounces: int = 8  # effective, after clamping
    max_queue_iters: int = 64  # safety bound on the wavefront loop
    enable_denoiser: bool = False
    photon_debug_mode: int = 0
    photon_debug_scale: float = 1.0  # Scene.PhotonDebugScale (RayGen.hlsl:511)
    # Photon mapping (M4): 0 disables the pass entirely
    num_photons: int = 0
    # Static scene-shape facts; like the reference's shader permutations,
    # changing these swaps the compiled pipeline.
    has_lights: bool = True
    any_glass: bool = True
    any_metal: bool = True
    # True when some glass material has a nonzero Beer-Lambert absorption
    # coefficient. When False, the thickness ray's only consumer
    # (exp(-absorption*thickness), RayGen.hlsl:646-678) is identically 1,
    # so the pipeline compiles the thickness trace out entirely.
    any_absorption: bool = True
    max_soft_samples: int = 1  # static unroll bound for soft-shadow sampling

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def effective_budget(spp: int, max_bounces: int) -> tuple:
    """Apply the reference's TDR ray budget (RayGen.hlsl:69-77)."""
    sample_count = min(max(int(spp), 1), C.MAX_SPP)
    mb = min(int(max_bounces), C.MAX_BOUNCES_CLAMP) if max_bounces > 0 else C.DEFAULT_MAX_BOUNCES
    if sample_count * mb > C.MAX_RAYS_PER_PIXEL:
        sample_count = max(1, C.MAX_RAYS_PER_PIXEL // mb)
    return sample_count, mb


def camera_basis(position, look_at, up):
    """Right-handed camera basis (DXRPipeline.cpp:736-747)."""
    pos = np.asarray(position, dtype=np.float64)
    fwd = np.asarray(look_at, dtype=np.float64) - pos
    n = np.linalg.norm(fwd)
    fwd = fwd / n if n > 1e-12 else np.array([0.0, 0.0, 1.0])
    right = np.cross(np.asarray(up, dtype=np.float64), fwd)
    n = np.linalg.norm(right)
    right = right / n if n > 1e-12 else np.array([1.0, 0.0, 0.0])
    real_up = np.cross(fwd, right)
    n = np.linalg.norm(real_up)
    real_up = real_up / n if n > 1e-12 else np.array([0.0, 1.0, 0.0])
    return fwd, right, real_up


def look_at_lh(eye, focus, up) -> np.ndarray:
    """XMMatrixLookAtLH (row-vector convention), Camera.cpp:26-33."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(focus, np.float64) - eye
    zn = np.linalg.norm(z)
    z = z / zn if zn > 1e-12 else np.array([0.0, 0.0, 1.0])
    x = np.cross(np.asarray(up, np.float64), z)
    xn = np.linalg.norm(x)
    x = x / xn if xn > 1e-12 else np.array([1.0, 0.0, 0.0])
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, 0] = -np.dot(x, eye)
    m[3, 1] = -np.dot(y, eye)
    m[3, 2] = -np.dot(z, eye)
    return m


def perspective_fov_lh(fov_deg: float, aspect: float, zn: float = 0.1, zf: float = 1000.0):
    """XMMatrixPerspectiveFovLH (row-vector convention), Camera.cpp:35-39."""
    h = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    w = h / aspect
    m = np.zeros((4, 4))
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = 1.0
    m[3, 2] = -zn * zf / (zf - zn)
    return m


def view_projection(scene: SceneData, aspect: float) -> np.ndarray:
    cam = scene.camera
    return look_at_lh(cam.position, cam.look_at, cam.up) @ perspective_fov_lh(
        cam.field_of_view, aspect
    )


def flatten_scene(scene: SceneData, *, frame_index: int = 0,
                  aspect: float = 16.0 / 9.0,
                  prev_view_proj: np.ndarray = None, mesh_service=None,
                  blas_cache=None) -> FlatScene:
    """Build the FlatScene pytree from an evaluated, sanitized SceneData.

    `mesh_service` resolves FBX mesh names (io.mesh_cache.MeshCacheService);
    instances whose mesh is missing are skipped, like the reference drops
    FBX nodes absent from the cache (SceneFileService.cs:52-62).
    `blas_cache` (ops.bvh.BLASCache) carries name-keyed object-space BLASes
    across scene updates so transform edits skip the SAH build.
    """
    f32 = np.float32
    spheres = scene.spheres
    planes = scene.planes
    boxes = scene.boxes
    instances = []
    if mesh_service is not None:
        for mi in scene.mesh_instances:
            cached = mesh_service.get_mesh(mi.mesh_name)
            if cached is not None:
                instances.append((mi, cached))

    s_cap = _pad_capacity(len(spheres), 2)
    p_cap = _pad_capacity(len(planes), 1)
    b_cap = _pad_capacity(len(boxes), 2)
    l_cap = _pad_capacity(len(scene.lights), 2)
    i_cap = len(instances)
    m_cap = max(1, s_cap + p_cap + b_cap + i_cap)

    sph_center = np.zeros((s_cap, 3), f32)
    sph_radius = np.full((s_cap,), 1.0, f32)
    sph_valid = np.zeros((s_cap,), bool)
    pln_position = np.zeros((p_cap, 3), f32)
    pln_normal = np.tile(np.array([0, 1, 0], f32), (p_cap, 1))
    pln_valid = np.zeros((p_cap,), bool)
    box_center = np.zeros((b_cap, 3), f32)
    box_half = np.full((b_cap, 3), 0.5, f32)
    box_axes = np.tile(np.eye(3, dtype=f32), (b_cap, 1, 1))
    box_valid = np.zeros((b_cap,), bool)

    mat_color = np.tile(np.array([0.8, 0.8, 0.8, 1.0], f32), (m_cap, 1))
    mat_metallic = np.zeros((m_cap,), f32)
    mat_roughness = np.full((m_cap,), 0.5, f32)
    mat_transmission = np.zeros((m_cap,), f32)
    mat_ior = np.full((m_cap,), 1.5, f32)
    mat_specular = np.full((m_cap,), 0.5, f32)
    mat_emission = np.zeros((m_cap, 3), f32)
    mat_absorption = np.zeros((m_cap, 3), f32)

    def put_material(slot, m):
        mat_color[slot] = np.asarray(m.base_color, f32)[:4]
        mat_metallic[slot] = m.metallic
        mat_roughness[slot] = m.roughness
        mat_transmission[slot] = m.transmission
        mat_ior[slot] = m.ior
        mat_specular[slot] = m.specular
        mat_emission[slot] = np.asarray(m.emission, f32).ravel()[:3]
        mat_absorption[slot] = np.asarray(m.absorption, f32)[:3]

    for i, s in enumerate(spheres):
        sph_center[i] = np.asarray(s.position, f32)
        sph_radius[i] = s.radius
        sph_valid[i] = True
        put_material(i, s.material)
    for i, p in enumerate(planes):
        pln_position[i] = np.asarray(p.position, f32)
        pln_normal[i] = np.asarray(p.normal, f32)
        pln_valid[i] = True
        put_material(s_cap + i, p.material)
    for i, b in enumerate(boxes):
        box_center[i] = np.asarray(b.center, f32)
        box_half[i] = np.asarray(b.size, f32)
        box_axes[i] = np.stack(
            [np.asarray(b.axis_x, f32), np.asarray(b.axis_y, f32), np.asarray(b.axis_z, f32)]
        )
        box_valid[i] = True
        put_material(s_cap + p_cap + i, b.material)

    lt_type = np.zeros((l_cap,), np.int32)
    lt_position = np.zeros((l_cap, 3), f32)
    lt_color = np.ones((l_cap, 4), f32)
    lt_intensity = np.zeros((l_cap,), f32)
    lt_radius = np.zeros((l_cap,), f32)
    lt_samples = np.ones((l_cap,), f32)
    lt_valid = np.zeros((l_cap,), bool)
    for i, lt in enumerate(scene.lights):
        lt_type[i] = int(lt.type)
        # Directional lights store direction in the position slot
        # (SceneEvaluator.cs:423-426, Common.hlsli:992).
        lt_position[i] = np.asarray(
            lt.direction if lt.type == LightType.DIRECTIONAL else lt.position, f32
        )
        lt_color[i] = np.asarray(lt.color, f32)[:4]
        lt_intensity[i] = lt.intensity
        lt_radius[i] = lt.radius
        # Store the true per-light count (shader contract: 1-16,
        # Common.hlsli:1226). The reference's TDR clamp to 1
        # (DXRPipeline.cpp:926-928) is applied via the static unroll bound
        # cfg.max_soft_samples (see make_config); lifting it with the
        # max_soft_samples override enables the full 1-16 sampling path.
        lt_samples[i] = min(max(lt.soft_shadow_samples, 1.0), 16.0)
        lt_valid[i] = True

    # Triangle meshes: BLAS/TLAS split. Object-space BLASes are SAH-built
    # once per mesh name (BLASCache, AccelerationStructure.cpp:560-663);
    # per-instance transforms are applied as a cheap linear retransform of
    # triangles + node bounds and the instances chained into one forest
    # (the combined-TLAS analog, AccelerationStructure.cpp:665-848).
    # Transform edits therefore never re-run the SAH builder.
    mesh_arrays = None
    if instances:
        from ..ops import bvh as bvh_mod

        if blas_cache is None:
            blas_cache = bvh_mod.BLASCache()
        world_blas = []
        inst_trans = []
        inst_absorb = []
        for inst_idx, (mi, cached) in enumerate(instances):
            blas = blas_cache.get(mi.mesh_name, cached)
            world_blas.append(
                bvh_mod.transform_blas(blas, mi.transform.matrix(), inst_idx)
            )
            put_material(s_cap + p_cap + b_cap + inst_idx, mi.material)
            inst_trans.append(mi.material.transmission)
            inst_absorb.append(np.asarray(mi.material.absorption, np.float64)[:3])
        built = bvh_mod.combine_blas(world_blas)
        mesh_arrays = bvh_mod.to_device(built, np.asarray(inst_trans, f32),
                                        np.asarray(inst_absorb, f32))

    fwd, right, up = camera_basis(scene.camera.position, scene.camera.look_at, scene.camera.up)
    st = scene.settings
    vp = view_projection(scene, aspect)
    pvp = vp if prev_view_proj is None else np.asarray(prev_view_proj, np.float64)

    return FlatScene(
        sph_center=jnp.asarray(sph_center),
        sph_radius=jnp.asarray(sph_radius),
        sph_valid=jnp.asarray(sph_valid),
        pln_position=jnp.asarray(pln_position),
        pln_normal=jnp.asarray(pln_normal),
        pln_valid=jnp.asarray(pln_valid),
        box_center=jnp.asarray(box_center),
        box_half=jnp.asarray(box_half),
        box_axes=jnp.asarray(box_axes),
        box_valid=jnp.asarray(box_valid),
        mat_color=jnp.asarray(mat_color),
        mat_metallic=jnp.asarray(mat_metallic),
        mat_roughness=jnp.asarray(mat_roughness),
        mat_transmission=jnp.asarray(mat_transmission),
        mat_ior=jnp.asarray(mat_ior),
        mat_specular=jnp.asarray(mat_specular),
        mat_emission=jnp.asarray(mat_emission),
        mat_absorption=jnp.asarray(mat_absorption),
        lt_type=jnp.asarray(lt_type),
        lt_position=jnp.asarray(lt_position),
        lt_color=jnp.asarray(lt_color),
        lt_intensity=jnp.asarray(lt_intensity),
        lt_radius=jnp.asarray(lt_radius),
        lt_samples=jnp.asarray(lt_samples),
        lt_valid=jnp.asarray(lt_valid),
        num_lights=jnp.asarray(len(scene.lights), jnp.int32),
        cam_pos=jnp.asarray(np.asarray(scene.camera.position, f32)),
        cam_forward=jnp.asarray(fwd.astype(f32)),
        cam_right=jnp.asarray(right.astype(f32)),
        cam_up=jnp.asarray(up.astype(f32)),
        tan_half_fov=jnp.asarray(
            math.tan(scene.camera.field_of_view * 0.5 * math.pi / 180.0), jnp.float32
        ),
        aperture_size=jnp.asarray(scene.camera.aperture_size, jnp.float32),
        focus_distance=jnp.asarray(scene.camera.focus_distance, jnp.float32),
        exposure=jnp.asarray(st.exposure, jnp.float32),
        tone_map_operator=jnp.asarray(st.tone_map_operator, jnp.int32),
        shadow_strength=jnp.asarray(st.shadow_strength, jnp.float32),
        shadow_absorption_scale=jnp.asarray(st.shadow_absorption_scale, jnp.float32),
        gamma=jnp.asarray(st.gamma, jnp.float32),
        atten_const=jnp.asarray(st.light_attenuation_constant, jnp.float32),
        atten_linear=jnp.asarray(st.light_attenuation_linear, jnp.float32),
        atten_quadratic=jnp.asarray(st.light_attenuation_quadratic, jnp.float32),
        max_shadow_lights=jnp.asarray(st.max_shadow_lights, jnp.int32),
        nrd_bypass_distance=jnp.asarray(st.nrd_bypass_distance, jnp.float32),
        nrd_bypass_blend=jnp.asarray(st.nrd_bypass_blend_range, jnp.float32),
        frame_index=jnp.asarray(frame_index, jnp.uint32),
        view_proj=jnp.asarray(vp, jnp.float32),
        prev_view_proj=jnp.asarray(pvp, jnp.float32),
        mesh=mesh_arrays,
    )


def make_config(scene: SceneData, width: int, height: int, **overrides) -> RenderConfig:
    spp, max_bounces = effective_budget(
        scene.settings.samples_per_pixel, scene.settings.max_bounces
    )
    # Iteration cap for the wavefront DFS loop: a sample's processed rays are
    # bounded by the reference's own budget (RayGen.hlsl:73 caps non-specular
    # work; specular trees are bounded by the 8-deep queue and max_bounces).
    max_iters = min(C.MAX_RAYS_PER_PIXEL, 4 * max_bounces + C.WORK_QUEUE_STRIDE)

    def _mat_of(o):
        return o.material

    mats = [o.material for o in scene.objects if hasattr(o, "material")]
    any_glass = any(m.transmission > 0.01 for m in mats)
    any_metal = any(m.metallic > 0.1 for m in mats)
    any_absorption = any(
        m.transmission > 0.01 and float(np.max(np.asarray(m.absorption)[:3])) > 1e-6
        for m in mats
    )
    # Default unroll bound 1 = the reference's current TDR clamp
    # (DXRPipeline.cpp:928). Pass max_soft_samples=N (<=16) as an override
    # to unlock multi-sample soft shadows (Common.hlsli:1199-1357 contract);
    # lanes still honor their per-light sample count via `s < num_samples`.
    max_soft = 1
    # enable_caustics is a semantic override (the reference's runtime
    # causticsEnabled toggle, DXRPipeline.cpp:985): it selects the photon
    # budget rather than being a RenderConfig field itself.
    caustics_on = bool(overrides.pop("enable_caustics", scene.settings.enable_caustics))
    num_photons = 0
    if caustics_on:
        from ..ops.photon import photon_budget

        num_photons = photon_budget(scene)
    cfg = dict(
        width=int(width),
        height=int(height),
        samples_per_pixel=spp,
        max_bounces=max_bounces,
        max_queue_iters=max_iters,
        enable_denoiser=bool(scene.settings.enable_denoiser),
        photon_debug_mode=int(scene.settings.photon_debug_mode),
        photon_debug_scale=float(scene.settings.photon_debug_scale),
        num_photons=num_photons,
        has_lights=len(scene.lights) > 0,
        any_glass=any_glass,
        any_metal=any_metal,
        any_absorption=any_absorption,
        max_soft_samples=max_soft,
    )
    cfg.update(overrides)
    return RenderConfig(**cfg)
