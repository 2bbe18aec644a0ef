"""Engine: the user-facing render runtime.

Plays the role of EngineWrapper + DXRPipeline orchestration
(src/RayTraceVS.Interop/EngineWrapper.h:18-58,
src/RayTraceVS.DXEngine/NativeBridge.h:120-154): create with a resolution,
push scenes into it, pull RGBA8 frames out. jit dispatch replaces command
lists and fences; the persistent compilation cache replaces the shader
cache (ShaderCache.cpp).

Example:
    engine = Engine(512, 512)
    engine.update_scene(scene_data)      # evaluated SceneData
    img = engine.render()                # np.uint8 [H, W, 4]
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..post import composite as composite_mod
from ..post import tonemap
from ..scene.data import SceneData
from ..scene.evaluator import evaluate_scene
from ..scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config
from ..scene.rtvs import load_graph
from ..scene.sanitize import sanitize_scene
from ..utils.checksum import scene_content_checksum


@partial(jax.jit, static_argnums=(1, 3))
def _render_pipeline(scene: FlatScene, cfg: RenderConfig, denoise_state,
                     want_aux: bool = True):
    """Full frame: wavefront render -> denoise -> composite -> RGBA8.

    `want_aux=False` (static) leaves the HDR / G-buffer / denoised aux
    outputs out of the result (benchmark and streaming paths that only
    consume the RGBA image)."""
    from ..ops.render import render_rows
    from ..post import denoise as denoise_mod

    out = render_rows(scene, cfg, jnp.int32(0), cfg.height)
    denoised = None
    if cfg.enable_denoiser and denoise_state is not None:
        dd, ds, dshadow, new_state = denoise_mod.denoise_frame(
            out.gbuffer, cfg.height, cfg.width, denoise_state
        )
        denoised = (dd, ds, dshadow)
        color01 = composite_mod.composite(
            out.gbuffer,
            out.raw_specular,
            scene.exposure,
            scene.tone_map_operator,
            scene.gamma,
            denoised_diffuse=dd,
            denoised_specular=ds,
            use_denoised=True,
            nrd_bypass_distance=scene.nrd_bypass_distance,
            nrd_bypass_blend=scene.nrd_bypass_blend,
        )
    else:
        new_state = denoise_state
        color01 = composite_mod.composite(
            out.gbuffer,
            out.raw_specular,
            scene.exposure,
            scene.tone_map_operator,
            scene.gamma,
            use_denoised=False,
        )
    rgba = tonemap.to_rgba8(color01).reshape(cfg.height, cfg.width, 4)
    if not want_aux:
        return rgba, None, out.rays, None, new_state, None
    hdr = out.color.reshape(cfg.height, cfg.width, 3)
    return rgba, hdr, out.rays, out.gbuffer, new_state, denoised


class Engine:
    """Render engine with EngineWrapper-compatible surface."""

    def __init__(self, width: int, height: int, mesh_service=None,
                 device_mesh="auto"):
        """device_mesh: a jax.sharding.Mesh to shard image rows over
        (parallel/tiles.py), None for single-device, or "auto" — shard
        when more than one device is visible and the height divides
        evenly (SURVEY §2.5: image-row sharding is the multi-device data
        parallelism; the reference is single-GPU).

        Turns on the persistent compilation cache (runtime/cache.py)."""
        from .cache import enable_compilation_cache

        enable_compilation_cache()
        self.width = int(width)
        self.height = int(height)
        self.mesh_service = mesh_service
        if device_mesh == "auto":
            devices = jax.devices()
            if len(devices) > 1 and self.height % len(devices) == 0:
                from ..parallel.tiles import make_mesh

                device_mesh = make_mesh(devices)
            else:
                device_mesh = None
        self.device_mesh = device_mesh
        self._flat: Optional[FlatScene] = None
        self._cfg: Optional[RenderConfig] = None
        self._scene: Optional[SceneData] = None
        self._frame_index = 0
        self._checksum = None
        self._last_rgba: Optional[np.ndarray] = None
        self._last_hdr: Optional[np.ndarray] = None
        self._last_gbuffer = None
        self._last_denoised = None  # (diffuse3, specular3, shadow2) lanes
        self._last_rays = 0
        self._last_render_ms = 0.0
        self._prev_view_proj = None
        self._denoise_state = None
        # Name-keyed object-space BLAS cache: SAH builds happen once per
        # mesh; transform edits only retransform (AccelerationStructure.cpp:
        # 560-663 name-keyed BLAS cache analog).
        from ..ops.bvh import BLASCache

        self._blas_cache = BLASCache()

    # -- scene input ------------------------------------------------------
    def update_scene(self, scene: SceneData, **config_overrides) -> None:
        """Sanitize + flatten a SceneData (EngineWrapper::UpdateScene)."""
        clean = sanitize_scene(scene)
        self._scene = clean
        # Verbose per-object scene dump at the interop boundary
        # (EngineWrapper.cpp:222-230), gated by log level like the reference.
        from ..utils.logging import log_debug

        log_debug(
            "UpdateScene: %d objects (%s), %d lights, spp=%d bounces=%d",
            len(clean.objects),
            ", ".join(type(o).__name__ for o in clean.objects) or "empty",
            len(clean.lights), clean.settings.samples_per_pixel,
            clean.settings.max_bounces,
        )
        aspect = self.width / self.height
        # Temporal-history reset keys off object GEOMETRY only, exactly like
        # the reference's FNV checksum (DXRPipeline.cpp:2795-2880): camera
        # moves keep history (motion vectors reproject it); moving an object
        # resets it to avoid ghosting. The RNG frame index is a monotonic
        # counter that never resets (DXRPipeline.cpp:779-780), and the
        # previous view-proj matrix is only reset at denoiser init
        # (DXRPipeline.cpp:3708-3711), not on scene change.
        new_checksum = scene_content_checksum(clean)
        if new_checksum != self._checksum:
            self._denoise_state = None
        self._checksum = new_checksum
        self._flat = flatten_scene(
            clean, frame_index=self._frame_index, aspect=aspect,
            prev_view_proj=self._prev_view_proj, mesh_service=self.mesh_service,
            blas_cache=self._blas_cache,
        )
        self._cfg = make_config(clean, self.width, self.height, **config_overrides)
        self._prev_view_proj = np.asarray(self._flat.view_proj)

    def load_rtvs(self, path: str, **config_overrides):
        """Convenience: load a .rtvs file and update the scene.

        Returns the loaded NodeGraph so callers that keep editing it (the
        viewer's property panel) can re-evaluate and push updates.
        """
        graph = self.load_rtvs_graph(path)
        self.update_scene(evaluate_scene(graph), **config_overrides)
        return graph

    def load_rtvs_graph(self, path: str):
        """Load a .rtvs node graph WITHOUT updating the scene.

        FBX mesh names resolve against Resource/Model next to the scene file
        (the reference scans the application's Resource/Model directory,
        MeshCacheService.cs:54-72), then against the meshes generated in
        code (io/mesh_cache.BUILTIN_MESHES); FBX nodes whose mesh is
        missing are dropped at load (SceneFileService.cs:52-62). The
        RAYTRACEVS_MODEL_PATH environment variable overrides the model
        directory, mirroring the reference's RAYTRACEVS_SHADER_PATH tier
        (DXRPipeline.cpp:191-342).
        """
        if self.mesh_service is None:
            from ..io.mesh_cache import MeshCacheService

            scene_dir = os.path.dirname(os.path.abspath(path))
            candidates = (os.environ.get("RAYTRACEVS_MODEL_PATH", ""),
                          os.path.join(scene_dir, "Resource", "Model"),
                          os.path.join(scene_dir, "Model"))
            model_dir = next((c for c in candidates if os.path.isdir(c)), None)
            svc = MeshCacheService(model_dir)
            try:
                svc.initialize()
            except OSError:
                svc = MeshCacheService()  # read-only model dir: built-ins
            self.mesh_service = svc
        resolver = self.mesh_service.get_mesh if self.mesh_service is not None else None
        return load_graph(path, mesh_resolver=resolver)

    # -- rendering --------------------------------------------------------
    def _sentinel(self, rgb) -> np.ndarray:
        """Color-coded failure fill (NativeBridge.cpp:266-356)."""
        img = np.zeros((self.height, self.width, 4), np.uint8)
        img[..., 0], img[..., 1], img[..., 2], img[..., 3] = (*rgb, 255)
        return img

    def render(self, fail_safe: bool = False) -> np.ndarray:
        """Render a frame; returns RGBA8 np.uint8 [H, W, 4] (readback analog).

        With fail_safe=True, failures return the reference's color-coded
        sentinel fills instead of raising: magenta = exception during
        render, orange = all-zero output (NativeBridge.cpp:266-356).
        """
        if fail_safe:
            try:
                img = self.render(fail_safe=False)
            except Exception:
                from ..utils.logging import log_error

                log_error("render failed; returning magenta sentinel")
                return self._sentinel((255, 0, 255))
            if not img[..., :3].any():
                return self._sentinel((255, 165, 0))
            return img
        if self._flat is None:
            raise RuntimeError("update_scene() must be called before render()")
        if self._cfg.enable_denoiser and self._denoise_state is None:
            from ..post import denoise as denoise_mod

            state = denoise_mod.init_state(self.height, self.width)
            if self.device_mesh is not None:
                # start row-sharded, as the sharded step returns it: one
                # compiled frame step serves every frame
                from ..parallel.tiles import TILE_AXIS

                state = jax.device_put(state, jax.sharding.NamedSharding(
                    self.device_mesh, jax.sharding.PartitionSpec(TILE_AXIS)))
            self._denoise_state = state
        start = time.perf_counter()
        if self.device_mesh is not None:
            from ..parallel.tiles import render_pipeline_sharded

            (rgba, hdr, rays, self._last_gbuffer, self._denoise_state,
             self._last_denoised) = render_pipeline_sharded(
                self._flat, self._cfg, self.device_mesh, self._denoise_state,
            )
            rgba = np.asarray(rgba).reshape(self.height, self.width, 4)
            hdr = np.asarray(hdr).reshape(self.height, self.width, 3)
            rays = np.asarray(rays).sum()
        else:
            (rgba, hdr, rays, self._last_gbuffer, self._denoise_state,
             self._last_denoised) = _render_pipeline(
                self._flat, self._cfg, self._denoise_state
            )
        rgba = np.asarray(rgba)
        self._last_render_ms = (time.perf_counter() - start) * 1000.0
        self._last_rgba = rgba
        self._last_hdr = np.asarray(hdr)
        self._last_rays = int(rays)
        self._frame_index += 1
        self._flat = self._flat._replace(
            frame_index=jnp.asarray(self._frame_index, jnp.uint32)
        )
        return rgba

    def render_debug_view(self, mode: int) -> np.ndarray:
        """Composite debug visualization of the last frame as RGBA8
        (Composite.hlsl:184-371 — the render window's DebugMode selector:
        1 = G-buffer tile strip, 2-4 = shadow input/denoised/split,
        5 = magenta fill, 6-8 = diffuse taps, 9/10 = photon views)."""
        if self._last_gbuffer is None:
            raise RuntimeError("render() must be called before render_debug_view()")
        from ..post.debug_modes import composite_debug
        from ..post import tonemap as tonemap_mod

        dd = ds = dsh = None
        if self._last_denoised is not None:
            dd, ds, dsh = self._last_denoised
        out01 = composite_debug(
            int(mode), self._last_gbuffer, self.height, self.width,
            denoised_diffuse=dd, denoised_specular=ds, denoised_shadow=dsh,
            exposure=float(self._scene.settings.exposure) if self._scene else 1.0,
            photon_map_size=self._cfg.num_photons if self._cfg else 0,
        )
        rgba = tonemap_mod.to_rgba8(out01.reshape(-1, 3))
        return np.asarray(rgba).reshape(self.height, self.width, 4)

    @property
    def last_hdr(self) -> Optional[np.ndarray]:
        """Linear HDR color of the last frame, before composite/tonemap —
        the `debugSkipPostFX` analog (DXRPipeline.cpp:2736)."""
        return self._last_hdr

    def validate_frame(self) -> dict:
        """Debug-layer analog (SURVEY §5.2): render one frame and audit every
        output channel for NaN/Inf and contract violations.

        The reference enables the D3D12 debug layer + GPU-based validation in
        Debug builds (DXContext.cpp:33-40); the compiled XLA pipeline is
        race-free by construction, so validation means checking the numeric
        contracts of the outputs. Returns {"ok": bool, "violations": [str]}.
        """
        from ..ops.render import render_frame
        from ..post import composite as composite_mod
        from .. import constants as C

        out = render_frame(self._flat, self._cfg)
        g = out.gbuffer
        v = []

        def finite(name, a):
            if not np.isfinite(np.asarray(a)).all():
                v.append(f"{name}: non-finite values")

        def in_range(name, a, lo, hi):
            a = np.asarray(a)
            if a.size and (a.min() < lo or a.max() > hi):
                v.append(f"{name}: out of [{lo}, {hi}] (min {a.min()}, max {a.max()})")

        finite("color", out.color)
        in_range("color", out.color, 0.0, np.inf)
        finite("raw_specular", out.raw_specular)
        finite("normal_roughness", g.normal_roughness)
        in_range("normal_roughness", g.normal_roughness, 0.0, 1.0)
        in_range("view_z", g.view_z, C.VIEWZ_MIN, C.VIEWZ_SKY)
        in_range("motion", g.motion, -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
        in_range("albedo", g.albedo, 0.0, 1.0)
        in_range("shadow visibility", np.asarray(g.shadow_data)[:, 1], 0.0, 1.0)
        oid = np.asarray(g.obj_id)
        if oid.size and oid.min() < -1:
            v.append(f"obj_id: below -1 (min {oid.min()})")
        color01 = composite_mod.composite(
            g, out.raw_specular, self._flat.exposure, self._flat.tone_map_operator,
            self._flat.gamma, use_denoised=False,
        )
        finite("composite", color01)
        in_range("composite", color01, 0.0, 1.0)
        return {"ok": not v, "violations": v}

    def get_pixel_data(self) -> bytes:
        """Raw RGBA bytes of the last frame (EngineWrapper::GetPixelData)."""
        if self._last_rgba is None:
            raise RuntimeError("render() must be called before get_pixel_data()")
        return self._last_rgba.tobytes()

    def copy_pixels_into(self, buffer) -> bool:
        """Fill a caller-provided writable buffer with the last frame's RGBA.

        The readback analog of NativeBridge::GetPixelData with its full set
        of color-coded failure fills (NativeBridge.cpp:266-356):
        green = pixel read failed, red = zero-size frame, yellow = buffer
        too small, orange = output was all zeros, magenta = exception.
        Returns True only on a clean copy.
        """
        mv = memoryview(buffer).cast("B")
        needed = self.width * self.height * 4

        def fill(rgb):
            n = min(len(mv), needed) if needed else len(mv)
            arr = np.frombuffer(mv, dtype=np.uint8, count=len(mv))
            px = arr[: n - n % 4].reshape(-1, 4)
            px[:, 0], px[:, 1], px[:, 2], px[:, 3] = (*rgb, 255)
            return False

        try:
            if needed == 0:
                return fill((255, 0, 0))  # red: zero-size frame
            if len(mv) < needed:
                return fill((255, 255, 0))  # yellow: buffer too small
            if self._last_rgba is None:
                return fill((0, 255, 0))  # green: no pixels to read
            data = self._last_rgba
            if not data[..., :3].any():
                return fill((255, 165, 0))  # orange: all-zero output
            np.frombuffer(mv, dtype=np.uint8, count=needed)[:] = data.reshape(-1)
            return True
        except Exception:
            from ..utils.logging import log_error

            log_error("copy_pixels_into failed; filling magenta sentinel")
            try:
                return fill((255, 0, 255))  # magenta: exception
            except Exception:
                return False

    # -- metrics ----------------------------------------------------------
    @property
    def last_render_ms(self) -> float:
        return self._last_render_ms

    @property
    def last_rays(self) -> int:
        """Rays traced in the last frame (TraceRay-equivalents)."""
        return self._last_rays

    @property
    def last_mrays_per_s(self) -> float:
        if self._last_render_ms <= 0:
            return 0.0
        return self._last_rays / (self._last_render_ms * 1e-3) / 1e6


def render_rtvs(path: str, width: int = 512, height: int = 512, **overrides) -> np.ndarray:
    """One-shot: render a .rtvs scene file to an RGBA8 array."""
    engine = Engine(width, height)
    engine.load_rtvs(path, **overrides)
    return engine.render()
