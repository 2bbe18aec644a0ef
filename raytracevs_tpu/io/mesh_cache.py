"""Binary mesh cache: FBX -> .mesh conversion with a JSON manifest.

Byte-compatible with the reference's cache format
(MeshCacheService.cs:23-25, 517-546): 40-byte header
("RTVS" magic, version 1, vertex count, index count, bounds min/max) then
interleaved 32-byte vertices (pos3 + pad + normal3 + pad) and u32 indices.
Startup scan + lazy thread-safe load mirror MeshCacheService.cs:54-199.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from . import fbx

CACHE_MAGIC = b"RTVS"
CACHE_VERSION = 1
FLOATS_PER_VERTEX = 8  # position(3) + pad + normal(3) + pad


@dataclass
class CachedMesh:
    name: str
    vertices: np.ndarray  # [V*8] float32 interleaved (pos3, pad, normal3, pad)
    indices: np.ndarray  # [I] uint32
    bounds_min: np.ndarray
    bounds_max: np.ndarray

    @property
    def vertex_count(self) -> int:
        return len(self.vertices) // FLOATS_PER_VERTEX

    @property
    def positions(self) -> np.ndarray:
        return self.vertices.reshape(-1, FLOATS_PER_VERTEX)[:, 0:3]

    @property
    def normals(self) -> np.ndarray:
        return self.vertices.reshape(-1, FLOATS_PER_VERTEX)[:, 4:7]


def write_mesh_cache(path: str, vertices: np.ndarray, indices: np.ndarray,
                     bounds_min, bounds_max) -> None:
    """Write the binary .mesh format (MeshCacheService.cs:517-546)."""
    v = np.asarray(vertices, np.float32).reshape(-1)
    idx = np.asarray(indices, np.uint32).reshape(-1)
    assert len(v) % FLOATS_PER_VERTEX == 0
    with open(path, "wb") as f:
        f.write(CACHE_MAGIC)
        f.write(struct.pack("<I", CACHE_VERSION))
        f.write(struct.pack("<I", len(v) // FLOATS_PER_VERTEX))
        f.write(struct.pack("<I", len(idx)))
        f.write(struct.pack("<3f", *np.asarray(bounds_min, np.float32)))
        f.write(struct.pack("<3f", *np.asarray(bounds_max, np.float32)))
        f.write(v.tobytes())
        f.write(idx.tobytes())


def read_mesh_cache(path: str, name: str = "") -> CachedMesh:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != CACHE_MAGIC:
            raise ValueError(f"bad mesh cache magic in {path}: {magic!r}")
        (version,) = struct.unpack("<I", f.read(4))
        if version != CACHE_VERSION:
            raise ValueError(f"unsupported mesh cache version {version} in {path}")
        (vertex_count,) = struct.unpack("<I", f.read(4))
        (index_count,) = struct.unpack("<I", f.read(4))
        bounds_min = np.frombuffer(f.read(12), np.float32).copy()
        bounds_max = np.frombuffer(f.read(12), np.float32).copy()
        vertices = np.frombuffer(f.read(vertex_count * FLOATS_PER_VERTEX * 4), np.float32).copy()
        indices = np.frombuffer(f.read(index_count * 4), np.uint32).copy()
    return CachedMesh(name or os.path.splitext(os.path.basename(path))[0],
                      vertices, indices, bounds_min, bounds_max)


def interleave(positions: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """[V,3]+[V,3] -> [V*8] interleaved with padding (32 B/vertex layout)."""
    v = np.zeros((len(positions), FLOATS_PER_VERTEX), np.float32)
    v[:, 0:3] = positions
    v[:, 4:7] = normals
    return v.reshape(-1)


def convert_fbx(fbx_path: str, cache_path: str) -> CachedMesh:
    """FBX -> binary .mesh (ConvertWithAssimp analog, MeshCacheService.cs:391-439)."""
    mesh = fbx.load_fbx(fbx_path)
    vertices = interleave(mesh.vertices, mesh.normals)
    write_mesh_cache(cache_path, vertices, mesh.indices, mesh.bounds_min, mesh.bounds_max)
    return CachedMesh(
        os.path.splitext(os.path.basename(fbx_path))[0],
        vertices, mesh.indices, mesh.bounds_min, mesh.bounds_max,
    )


# Profile of the canonical scene's wine glass (assets/sample_scene.rtvs,
# mesh "WineGlass2"): outer halfwidth against height in the asset's local
# units. The scene node scales the asset by 0.3, so the glass stands 3.02
# world units tall with a 0.43 rim halfwidth: a tulip bowl over a thin stem
# and a flat foot.
_GLASS_HEIGHTS = [0.00, 0.30, 0.60, 0.84, 2.83, 3.17, 3.67, 4.17, 4.83,
                  5.83, 7.30, 8.70, 10.05]
_GLASS_RADII = [1.27, 1.27, 0.40, 0.13, 0.13, 0.33, 0.67, 1.00, 1.50,
                1.83, 1.73, 1.60, 1.43]
_GLASS_WALL = 0.08  # bowl wall thickness
_GLASS_BOWL_FLOOR = 3.4  # height of the bowl's inner floor on the axis


def _glass_profile_polyline() -> np.ndarray:
    """Closed (radius, height) outline of the solid glass, axis to axis:
    foot bottom, outer wall up to the rim, inner bowl wall down to the
    bowl floor."""
    outer = [(0.0, 0.0)] + list(zip(_GLASS_RADII, _GLASS_HEIGHTS))
    inner_h = np.linspace(_GLASS_HEIGHTS[-1], _GLASS_BOWL_FLOOR + 0.6, 8)
    inner_r = np.interp(inner_h, _GLASS_HEIGHTS, _GLASS_RADII) - _GLASS_WALL
    inner = list(zip(inner_r, inner_h)) + [(0.0, _GLASS_BOWL_FLOOR)]
    return np.asarray(outer + inner, np.float64)


def _subdivide(poly: np.ndarray, n_points: int) -> np.ndarray:
    """Split the polyline's segments into n_points-1 pieces in all, each
    segment getting pieces in proportion to its length (every original
    corner is kept, so the rim and the foot edge stay sharp)."""
    seg_len = np.linalg.norm(np.diff(poly, axis=0), axis=1)
    pieces = np.ones(len(seg_len), np.int64)
    for _ in range(n_points - 1 - len(seg_len)):
        pieces[int(np.argmax(seg_len / pieces))] += 1
    out = [poly[0]]
    for k, n in enumerate(pieces):
        for j in range(1, n + 1):
            out.append(poly[k] + (poly[k + 1] - poly[k]) * (j / n))
    return np.asarray(out)


def wine_glass_mesh(name: str = "WineGlass2", segments: int = 64,
                    profile_points: int = 48) -> CachedMesh:
    """The canonical scene's wine glass as a watertight lathe of the
    profile above: `segments` columns around the axis, `profile_points`
    rings along the outline, 2 * segments * (profile_points - 2)
    triangles (5,888 by default). Built deterministically in code, so no
    mesh asset ships with the repository.

    The asset stands along -Z (height h at z = -h): the scene node's +90
    degree rotation about X stands it upright. Triangles wind outward and
    vertex normals are area-weighted face normals, so front faces are the
    glass's outside, as the renderer's refraction expects."""
    prof = _subdivide(_glass_profile_polyline(), profile_points)
    r, h = prof[:, 0], prof[:, 1]
    phi = 2.0 * np.pi * np.arange(segments) / segments
    # ring j, column s -> vertex j * segments + s (columns wrap around)
    pos = np.stack([np.outer(r, np.cos(phi)), np.outer(r, np.sin(phi)),
                    np.outer(-h, np.ones(segments))], axis=-1).reshape(-1, 3)
    tris = []
    for j in range(len(prof) - 1):
        for s in range(segments):
            a, b = j * segments + s, j * segments + (s + 1) % segments
            c, d = a + segments, b + segments
            if r[j] > 0.0:
                tris.append((a, b, d))
            if r[j + 1] > 0.0:
                tris.append((a, d, c))
    idx = np.asarray(tris, np.int64)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    face = np.cross(p1 - p0, p2 - p0)
    # orient outward: the foot's underside (first ring band) faces +Z
    if face[:segments, 2].sum() < 0.0:
        idx = idx[:, ::-1]
        face = -face
    nrm = np.zeros_like(pos)
    for k in range(3):
        np.add.at(nrm, idx[:, k], face)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return CachedMesh(name, interleave(pos.astype(np.float32),
                                       nrm.astype(np.float32)),
                      idx.reshape(-1).astype(np.uint32),
                      pos.min(axis=0).astype(np.float32),
                      pos.max(axis=0).astype(np.float32))


# Meshes generated in code, served when no cached FBX of that name exists.
BUILTIN_MESHES = {"WineGlass2": wine_glass_mesh}


class MeshCacheService:
    """Scan model dirs, convert outdated FBX files, serve meshes lazily.

    Mirrors MeshCacheService.cs:54-199: manifest `cache.json`, orphan
    cleanup, thread-safe lazy loads keyed by mesh name.
    """

    def __init__(self, model_dir: Optional[str] = None,
                 cache_dir: Optional[str] = None):
        """model_dir None serves only registered and built-in meshes."""
        self.model_dir = model_dir
        self.cache_dir = cache_dir or (
            os.path.join(model_dir, ".meshcache") if model_dir else None)
        self._meshes: Dict[str, CachedMesh] = {}
        self._known: Dict[str, str] = {}  # name -> cache path
        self._lock = threading.Lock()

    def initialize(self) -> None:
        if self.cache_dir is None:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        manifest_path = os.path.join(self.cache_dir, "cache.json")
        manifest = {}
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                manifest = {}

        fbx_files = {}
        if self.model_dir and os.path.isdir(self.model_dir):
            for fn in os.listdir(self.model_dir):
                if fn.lower().endswith(".fbx"):
                    fbx_files[os.path.splitext(fn)[0]] = os.path.join(self.model_dir, fn)

        # Convert new/outdated FBX files
        for name, path in fbx_files.items():
            cache_path = os.path.join(self.cache_dir, name + ".mesh")
            mtime = os.path.getmtime(path)
            entry = manifest.get(name, {})
            if not os.path.exists(cache_path) or entry.get("mtime") != mtime:
                try:
                    convert_fbx(path, cache_path)
                    manifest[name] = {"mtime": mtime, "source": path}
                except Exception:
                    continue
            self._known[name] = cache_path

        # Orphan cleanup (MeshCacheService.cs:171-199)
        for fn in list(os.listdir(self.cache_dir)):
            if fn.endswith(".mesh") and os.path.splitext(fn)[0] not in fbx_files:
                try:
                    os.remove(os.path.join(self.cache_dir, fn))
                except OSError:
                    pass
        manifest = {k: v for k, v in manifest.items() if k in fbx_files}
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)

    def register(self, name: str, mesh: CachedMesh) -> None:
        """Directly register an in-memory mesh (programmatic scenes)."""
        with self._lock:
            self._meshes[name] = mesh

    def get_mesh(self, name: str) -> Optional[CachedMesh]:
        """Serve a mesh by name (GetMesh, MeshCacheService.cs:86-118).

        Cached FBX meshes and registered meshes first; on a miss, a mesh
        that BUILTIN_MESHES generates in code (the canonical scene's
        "WineGlass2"). Unknown names return None, and the scene loader
        then drops the node like the reference (HasMesh,
        MeshCacheService.cs:77-80).
        """
        with self._lock:
            mesh = self._get_exact(name)
            if mesh is None and name in BUILTIN_MESHES:
                mesh = BUILTIN_MESHES[name](name)
                self._meshes[name] = mesh
            return mesh

    def _get_exact(self, name: str) -> Optional[CachedMesh]:
        if name in self._meshes:
            return self._meshes[name]
        path = self._known.get(name)
        if path is None or not os.path.exists(path):
            return None
        mesh = read_mesh_cache(path, name)
        self._meshes[name] = mesh
        return mesh

    def has_mesh(self, name: str) -> bool:
        """HasMesh analog (MeshCacheService.cs:77-80) incl. built-in meshes."""
        return self.get_mesh(name) is not None

    def mesh_names(self):
        with self._lock:
            return sorted(set(self._known) | set(self._meshes))
