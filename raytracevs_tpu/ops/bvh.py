"""Triangle-mesh BVH: host-side build + vectorized device traversal.

Software replacement for the reference's driver-built triangle BLAS
(AccelerationStructure.cpp:560-663) and hardware traversal. The BVH is
built once per scene update on the host (the reference also rebuilds BLAS
on changed frames, DXRPipeline.cpp:2863-2872) as a *threaded* (skip-link)
tree laid out in DFS preorder: every node stores `hit_next` (preorder
successor when its AABB is hit) and `miss_next` (successor when missed), so
device traversal is a stackless pointer chase — per-lane gathers over flat
arrays, a `lax.while_loop` until every lane walks off the tree. Instance
transforms are baked into world-space triangle soup (the reference's
combined TLAS also stores per-instance transforms,
AccelerationStructure.cpp:665-848).

Triangle hits use a precomputed plane + barycentric-projector test
(`plane_repr`, equivalent to Möller-Trumbore up to rounding but ~half the
per-(ray,triangle) ops in the hot leaf loops); shading
normals interpolate the smooth vertex normals with a separate geometric
face normal for robust front-face handling on thin shells
(ClosestHit_Triangle.hlsl:14-136).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .. import constants as C

F32 = jnp.float32
I32 = jnp.int32

LEAF_SIZE = 4
_END = -1


@dataclass
class BuiltBVH:
    """Host-side build result (numpy)."""

    # nodes in DFS preorder
    bbox_min: np.ndarray  # [Nn,3]
    bbox_max: np.ndarray  # [Nn,3]
    hit_next: np.ndarray  # [Nn] next node if AABB hit (leaf: == miss_next)
    miss_next: np.ndarray  # [Nn] next node if missed (-1 = done)
    tri_start: np.ndarray  # [Nn] leaf triangle range start (internal: 0)
    tri_count: np.ndarray  # [Nn] leaf triangle count (internal: 0)
    # triangle soup, leaf-ordered
    v0: np.ndarray  # [T,3]
    edge1: np.ndarray  # [T,3]
    edge2: np.ndarray  # [T,3]
    n0: np.ndarray  # [T,3] smooth vertex normals
    n1: np.ndarray
    n2: np.ndarray
    inst: np.ndarray  # [T] instance index (material lookup)


def build_bvh(v0, v1, v2, n0, n1, n2, inst, leaf_size: int = LEAF_SIZE,
              use_native: bool = True) -> BuiltBVH:
    """BVH over world-space triangles in threaded preorder layout.

    Prefers the native binned-SAH builder (csrc/rtvs_native.cpp) — the
    driver-BLAS-build analog — and falls back to a pure-numpy median split.
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = len(v0)
    if t == 0:
        raise ValueError("empty triangle list")

    # SBVH-style reference pre-splitting (RTVS_PRESPLIT=<budget factor>,
    # e.g. 2.0 = up to 2x references): sliver triangles — surfaces of
    # revolution like the wine glass tessellate into long thin quads —
    # get several tight clipped boxes instead of one fat one, cutting
    # leaf visits. The driver BLAS the reference
    # leans on (AccelerationStructure.cpp:560-663, PREFER_FAST_TRACE)
    # does equivalent splitting internally. Duplicated leaf entries are
    # harmless for closest/thickness walks (min-reduce); shadow walks
    # can double-multiply a crossing's Beer-Lambert factor when both
    # clipped boxes are visited — the same duplicate-any-hit semantics
    # DXR exhibits without NO_DUPLICATE_ANYHIT_INVOCATION, which the
    # reference does not set.
    presplit = float(os.environ.get("RTVS_PRESPLIT", "0") or 0)
    if presplit > 1.0 and use_native:
        from ..io import native as native_mod

        sp = native_mod.presplit_native(v0, v1, v2, presplit)
        if sp is not None:
            ref_tri, ref_min, ref_max = sp
            res = native_mod.build_bvh_refs_native(ref_min, ref_max, leaf_size)
            if res is not None:
                (bbox_min, bbox_max, hit_next, miss_next, tri_start,
                 tri_count, order) = res
                o = ref_tri[order.astype(np.int64)].astype(np.int64)
                e1 = (np.asarray(v1) - np.asarray(v0)).astype(np.float32)
                e2 = (np.asarray(v2) - np.asarray(v0)).astype(np.float32)
                return BuiltBVH(
                    bbox_min=bbox_min, bbox_max=bbox_max,
                    hit_next=hit_next, miss_next=miss_next,
                    tri_start=tri_start, tri_count=tri_count,
                    v0=v0[o], edge1=e1[o], edge2=e2[o],
                    n0=np.asarray(n0, np.float32)[o],
                    n1=np.asarray(n1, np.float32)[o],
                    n2=np.asarray(n2, np.float32)[o],
                    inst=np.asarray(inst, np.int32)[o],
                )

    if use_native:
        from ..io import native as native_mod

        res = native_mod.build_bvh_native(v0, v1, v2, leaf_size)
        if res is not None:
            bbox_min, bbox_max, hit_next, miss_next, tri_start, tri_count, order = res
            o = order.astype(np.int64)
            e1 = (np.asarray(v1) - np.asarray(v0)).astype(np.float32)
            e2 = (np.asarray(v2) - np.asarray(v0)).astype(np.float32)
            return BuiltBVH(
                bbox_min=bbox_min, bbox_max=bbox_max,
                hit_next=hit_next, miss_next=miss_next,
                tri_start=tri_start, tri_count=tri_count,
                v0=v0[o], edge1=e1[o], edge2=e2[o],
                n0=np.asarray(n0, np.float32)[o],
                n1=np.asarray(n1, np.float32)[o],
                n2=np.asarray(n2, np.float32)[o],
                inst=np.asarray(inst, np.int32)[o],
            )
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(t)
    nodes = []  # (bbmin, bbmax, left_child_node|None, tri_start, tri_count)

    def build(idx: np.ndarray) -> int:
        my = len(nodes)
        nodes.append(None)
        bb_min = tri_min[idx].min(axis=0)
        bb_max = tri_max[idx].max(axis=0)
        if len(idx) <= leaf_size:
            start = build.cursor
            build.order[start : start + len(idx)] = idx
            build.cursor += len(idx)
            nodes[my] = (bb_min, bb_max, None, None, start, len(idx))
            return my
        axis = int(np.argmax(bb_max - bb_min))
        med = np.argsort(centroid[idx, axis], kind="stable")
        half = len(idx) // 2
        left_idx = idx[med[:half]]
        right_idx = idx[med[half:]]
        left = build(left_idx)
        right = build(right_idx)
        nodes[my] = (bb_min, bb_max, left, right, 0, 0)
        return my

    build.cursor = 0
    build.order = np.zeros(t, np.int64)
    build(order)

    n_nodes = len(nodes)
    bbox_min = np.zeros((n_nodes, 3), np.float32)
    bbox_max = np.zeros((n_nodes, 3), np.float32)
    hit_next = np.full(n_nodes, _END, np.int32)
    miss_next = np.full(n_nodes, _END, np.int32)
    tri_start = np.zeros(n_nodes, np.int32)
    tri_count = np.zeros(n_nodes, np.int32)

    def thread(node: int, miss: int) -> None:
        bb_min, bb_max, left, right, start, count = nodes[node]
        bbox_min[node] = bb_min
        bbox_max[node] = bb_max
        miss_next[node] = miss
        if left is None:  # leaf
            tri_start[node] = start
            tri_count[node] = count
            hit_next[node] = miss
        else:
            hit_next[node] = left  # preorder: left == node+1
            thread(left, right)
            thread(right, miss)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n_nodes + 100))
    try:
        thread(0, _END)
    finally:
        sys.setrecursionlimit(old_limit)

    o = build.order
    e1 = (np.asarray(v1) - np.asarray(v0)).astype(np.float32)
    e2 = (np.asarray(v2) - np.asarray(v0)).astype(np.float32)
    return BuiltBVH(
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        hit_next=hit_next,
        miss_next=miss_next,
        tri_start=tri_start,
        tri_count=tri_count,
        v0=np.asarray(v0, np.float32)[o],
        edge1=e1[o],
        edge2=e2[o],
        n0=np.asarray(n0, np.float32)[o],
        n1=np.asarray(n1, np.float32)[o],
        n2=np.asarray(n2, np.float32)[o],
        inst=np.asarray(inst, np.int32)[o],
    )


class BLASCache:
    """Name-keyed cache of object-space BLASes.

    The reference builds one triangle BLAS per mesh name and caches it;
    scene updates only rebuild the TLAS with fresh per-instance transforms
    (AccelerationStructure.cpp:560-663 name-keyed cache, :665-848 combined
    TLAS). Here the analog: the SAH build runs once per mesh in object
    space; per-frame instance transforms are applied by `transform_blas`
    (linear map on triangles, transformed-corner bounds on node AABBs) —
    O(T + Nn) numpy work, no SAH rebuild.
    """

    def __init__(self):
        self._cache: dict = {}
        self.build_count = 0  # SAH builds performed (tests assert on this)

    def get(self, name: str, cached_mesh, leaf_size: int = None) -> "BuiltBVH":
        import zlib

        if leaf_size is None:
            leaf_size = LEAF_SIZE  # read the module global at call time
        # Content fingerprint guards against the same mesh NAME mapping to
        # different geometry across a long-lived engine session (mesh file
        # edited on disk, mesh_service swapped): a name-only key would
        # silently serve the stale BLAS. crc32 over the raw arrays is
        # ~0.3 ms for the wine glass — negligible next to a scene update.
        pos_a = np.ascontiguousarray(cached_mesh.positions)
        nrm_a = np.ascontiguousarray(cached_mesh.normals)
        idx = np.ascontiguousarray(cached_mesh.indices)
        fp = (pos_a.size, idx.size, zlib.crc32(pos_a.tobytes()),
              zlib.crc32(nrm_a.tobytes()), zlib.crc32(idx.tobytes()),
              leaf_size)
        entry = self._cache.get(name)
        if entry is None or entry[0] != fp:
            pos = np.asarray(cached_mesh.positions, np.float32)
            nrm = np.asarray(cached_mesh.normals, np.float32)
            tris = np.asarray(cached_mesh.indices).reshape(-1, 3).astype(np.int64)
            blas = build_bvh(
                pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]],
                nrm[tris[:, 0]], nrm[tris[:, 1]], nrm[tris[:, 2]],
                np.zeros(len(tris), np.int32), leaf_size=leaf_size,
            )
            self.build_count += 1
            self._cache[name] = (fp, blas)  # one entry per name: bounded
        return self._cache[name][1]


def transform_blas(b: BuiltBVH, m4: np.ndarray, inst_index: int) -> BuiltBVH:
    """World-space copy of an object-space BLAS under a row-vector TRS m4.

    Triangles map linearly (v' = v @ M + t, edges e' = e @ M), normals by
    the inverse transpose, and node AABBs by bounding the 8 transformed box
    corners — exact for the transformed parallelepiped, hence conservative
    for its triangles. Topology (hit/miss links, leaf ranges) is untouched,
    which is the whole point: a transform edit costs no SAH rebuild
    (AccelerationStructure.cpp:665-848 semantics).
    """
    M = np.asarray(m4[:3, :3], np.float64)
    t = np.asarray(m4[3, :3], np.float64)
    nmat = np.linalg.inv(M).T

    v0 = (b.v0.astype(np.float64) @ M + t).astype(np.float32)
    e1 = (b.edge1.astype(np.float64) @ M).astype(np.float32)
    e2 = (b.edge2.astype(np.float64) @ M).astype(np.float32)

    def xn(n):
        w = n.astype(np.float64) @ nmat
        ln = np.linalg.norm(w, axis=1, keepdims=True)
        return (w / np.where(ln < 1e-12, 1.0, ln)).astype(np.float32)

    lo, hi = b.bbox_min.astype(np.float64), b.bbox_max.astype(np.float64)
    new_lo = np.full_like(lo, np.inf)
    new_hi = np.full_like(hi, -np.inf)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = np.stack(
                    [hi[:, 0] if cx else lo[:, 0],
                     hi[:, 1] if cy else lo[:, 1],
                     hi[:, 2] if cz else lo[:, 2]], axis=1
                )
                w = corner @ M + t
                new_lo = np.minimum(new_lo, w)
                new_hi = np.maximum(new_hi, w)

    return BuiltBVH(
        bbox_min=new_lo.astype(np.float32), bbox_max=new_hi.astype(np.float32),
        hit_next=b.hit_next, miss_next=b.miss_next,
        tri_start=b.tri_start, tri_count=b.tri_count,
        v0=v0, edge1=e1, edge2=e2,
        n0=xn(b.n0), n1=xn(b.n1), n2=xn(b.n2),
        inst=np.full(len(b.v0), inst_index, np.int32),
    )


def combine_blas(blas_list) -> BuiltBVH:
    """Chain world-space BLASes into one traversable forest.

    Instance i's exit links (_END) retarget to instance i+1's root — a
    degenerate but correct TLAS (each ray prunes whole instances at their
    root AABB test). The reference's combined TLAS is the analog
    (AccelerationStructure.cpp:665-848); with the handful of instances its
    scenes carry, a linear instance chain is within noise of a real
    top-level tree.
    """
    if len(blas_list) == 1:
        return blas_list[0]
    node_off = np.cumsum([0] + [len(b.bbox_min) for b in blas_list])
    tri_off = np.cumsum([0] + [len(b.v0) for b in blas_list])

    def links(b, i):
        nxt = node_off[i + 1] if i + 1 < len(blas_list) else _END
        hit = np.where(b.hit_next == _END, nxt, b.hit_next + node_off[i])
        miss = np.where(b.miss_next == _END, nxt, b.miss_next + node_off[i])
        return hit.astype(np.int32), miss.astype(np.int32)

    hits, misses = zip(*(links(b, i) for i, b in enumerate(blas_list)))
    return BuiltBVH(
        bbox_min=np.concatenate([b.bbox_min for b in blas_list]),
        bbox_max=np.concatenate([b.bbox_max for b in blas_list]),
        hit_next=np.concatenate(hits),
        miss_next=np.concatenate(misses),
        tri_start=np.concatenate(
            [b.tri_start + tri_off[i] for i, b in enumerate(blas_list)]
        ).astype(np.int32),
        tri_count=np.concatenate([b.tri_count for b in blas_list]),
        v0=np.concatenate([b.v0 for b in blas_list]),
        edge1=np.concatenate([b.edge1 for b in blas_list]),
        edge2=np.concatenate([b.edge2 for b in blas_list]),
        n0=np.concatenate([b.n0 for b in blas_list]),
        n1=np.concatenate([b.n1 for b in blas_list]),
        n2=np.concatenate([b.n2 for b in blas_list]),
        inst=np.concatenate([b.inst for b in blas_list]),
    )


class MeshArrays(NamedTuple):
    """Device-side BVH + triangle arrays (a jax pytree)."""

    bbox_min: jnp.ndarray
    bbox_max: jnp.ndarray
    hit_next: jnp.ndarray
    miss_next: jnp.ndarray
    tri_start: jnp.ndarray
    tri_count: jnp.ndarray
    v0: jnp.ndarray
    edge1: jnp.ndarray
    edge2: jnp.ndarray
    n0: jnp.ndarray
    n1: jnp.ndarray
    n2: jnp.ndarray
    inst: jnp.ndarray  # [T] i32 instance index
    inst_transmission: jnp.ndarray  # [Ninst]
    inst_absorption: jnp.ndarray  # [Ninst,3]
    @property
    def num_nodes(self) -> int:
        return self.bbox_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def to_device(b: BuiltBVH, inst_transmission, inst_absorption) -> MeshArrays:
    """Upload a built BVH."""
    return MeshArrays(
        bbox_min=jnp.asarray(b.bbox_min),
        bbox_max=jnp.asarray(b.bbox_max),
        hit_next=jnp.asarray(b.hit_next),
        miss_next=jnp.asarray(b.miss_next),
        tri_start=jnp.asarray(b.tri_start),
        tri_count=jnp.asarray(b.tri_count),
        v0=jnp.asarray(b.v0),
        edge1=jnp.asarray(b.edge1),
        edge2=jnp.asarray(b.edge2),
        n0=jnp.asarray(b.n0),
        n1=jnp.asarray(b.n1),
        n2=jnp.asarray(b.n2),
        inst=jnp.asarray(b.inst),
        inst_transmission=jnp.asarray(inst_transmission, jnp.float32),
        inst_absorption=jnp.asarray(inst_absorption, jnp.float32),
    )


def _ray_aabb(o, inv_d, bb_min, bb_max, tmin, tmax):
    """Slab test; o/inv_d [N,3], bb [N,3]. Returns hit mask [N]."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(lo, axis=-1), tmin)
    t_far = jnp.minimum(jnp.min(hi, axis=-1), tmax)
    return t_near <= t_far


def _tri_hit(o, d, v0, e1, e2, tmin, tmax):
    """Möller-Trumbore; returns (hit [N], t [N], u [N], v [N])."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    ok = jnp.abs(det) > 1e-9  # TRIANGLE_CULL_DISABLE: both windings hit
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin) & (t <= tmax)
    return hit, t, u, v


def plane_repr(v0, e1, e2):
    """Precomputed plane + barycentric-projector triangle representation.

    For x on the triangle's plane: u = pu.x + pu0, v = pv.x + pv0, and the
    plane is n.x = d0 with n = e1 x e2 (the unnormalized geometric normal,
    so |n.d| > 1e-9 matches Moller-Trumbore's |det| > 1e-9 cull guard —
    det = e1.(d x e2) = -n.d). This halves the per-(ray,triangle) op
    count versus Moller-Trumbore (ClosestHit_Triangle.hlsl semantics
    unchanged — same u/v/t up to rounding).

    Returns (n [T,3], d0 [T], pu [T,3], pu0 [T], pv [T,3], pv0 [T]).
    """
    n = jnp.cross(e1, e2)
    nn = jnp.sum(n * n, axis=-1)
    safe = nn > 1e-24
    inv = jnp.where(safe, 1.0 / jnp.where(safe, nn, 1.0), 0.0)[:, None]
    pu = jnp.cross(e2, n) * inv
    pv = jnp.cross(n, e1) * inv
    d0 = jnp.sum(n * v0, axis=-1)
    pu0 = -jnp.sum(pu * v0, axis=-1)
    pv0 = -jnp.sum(pv * v0, axis=-1)
    return n, d0, pu, pu0, pv, pv0


def _tri_hit_plane(o, d, n, d0, pu, pu0, pv, pv0, tmin, tmax):
    """Plane-repr triangle test; same contract as `_tri_hit`."""
    nd = jnp.sum(n * d, axis=-1)
    no = jnp.sum(n * o, axis=-1)
    ok = jnp.abs(nd) > 1e-9  # both windings hit (TRIANGLE_CULL_DISABLE)
    t = (d0 - no) / jnp.where(ok, nd, 1.0)
    hx = o + t[..., None] * d
    u = jnp.sum(pu * hx, axis=-1) + pu0
    v = jnp.sum(pv * hx, axis=-1) + pv0
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin) & (t <= tmax)
    return hit, t, u, v


def _plane_table(v0, e1, e2):
    """[T,12] row-packed plane repr: n(0:3) d0(3) pu(4:7) pu0(7) pv(8:11) pv0(11)."""
    n, d0, pu, pu0, pv, pv0 = plane_repr(v0, e1, e2)
    return jnp.concatenate(
        [n, d0[:, None], pu, pu0[:, None], pv, pv0[:, None]], axis=-1
    )


def _tri_hit_plane_row(o, d, row, tmin, tmax):
    """Plane test from gathered [N,12] plane-table rows."""
    return _tri_hit_plane(
        o, d, row[:, 0:3], row[:, 3], row[:, 4:7], row[:, 7], row[:, 8:11],
        row[:, 11], tmin, tmax,
    )


class TriHit(NamedTuple):
    hit: jnp.ndarray  # [N]
    t: jnp.ndarray  # [N]
    tri: jnp.ndarray  # [N] triangle index
    u: jnp.ndarray  # [N] barycentric
    v: jnp.ndarray  # [N]
    inst: jnp.ndarray  # [N] instance index
    thick_hit: jnp.ndarray = None  # [N] fused same-instance thickness found
    thick_t: jnp.ndarray = None  # [N] its distance


def traverse_closest(mesh: MeshArrays, o, d, tmin, tmax, max_steps: Optional[int] = None,
                     skip_active=None, skip_inst=None, thick_inst=None) -> TriHit:
    """Stackless closest-hit traversal over [N] lanes.

    skip_active/skip_inst implement RAYFLAG_SKIP_SELF for mesh instances
    (AnyHit_SkipSelf.hlsl triangle variant).

    thick_inst ([N] i32, -1 = none): lanes with a pending same-instance
    thickness query resolve it during this walk (their t interval stays
    open until the first same-instance hit — AcceptHitAndEndSearch parity,
    AnyHit_Thickness_Triangle) instead of paying a separate
    traverse_thickness (same threaded order, same per-triangle rule).
    """
    n = o.shape[0]
    if max_steps is None:
        max_steps = mesh.num_nodes + 1
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    pk = _plane_table(mesh.v0, mesh.edge1, mesh.edge2)
    if skip_active is None:
        skip_active = jnp.zeros((n,), bool)
        skip_inst = jnp.zeros((n,), I32)
    track = thick_inst is not None
    big = jnp.float32(1e30)

    def cond(carry):
        return (carry[0] < max_steps) & jnp.any(carry[1] != _END)

    def body(carry):
        if track:
            step, node, best_t, best_tri, best_u, best_v, thick_t, thick_f = carry
            pend = (thick_inst >= 0) & ~thick_f
            bound = jnp.where(pend, big, best_t)
        else:
            step, node, best_t, best_tri, best_u, best_v = carry
            pend = None
            bound = best_t
        live = node != _END
        ni = jnp.clip(node, 0, mesh.num_nodes - 1)
        bb_min = mesh.bbox_min[ni]
        bb_max = mesh.bbox_max[ni]
        box_hit = live & _ray_aabb(o, inv_d, bb_min, bb_max, tmin, bound)

        count = mesh.tri_count[ni]
        start = mesh.tri_start[ni]
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf
        for k in range(LEAF_SIZE):
            ti = jnp.clip(start + k, 0, mesh.num_tris - 1)
            valid = do_leaf & (k < count)
            bnd = jnp.where(pend, big, best_t) if track else best_t
            th, tt, tu, tv = _tri_hit_plane_row(o, d, pk[ti], tmin, bnd)
            th = th & valid
            if track:
                tm = th & (mesh.inst[ti] == thick_inst) & (tt < thick_t)
                thick_t = jnp.where(tm, tt, thick_t)
                thick_f = thick_f | tm
            th = th & ~(skip_active & (mesh.inst[ti] == skip_inst))
            better = th & (tt < best_t)
            best_t = jnp.where(better, tt, best_t)
            best_tri = jnp.where(better, ti, best_tri)
            best_u = jnp.where(better, tu, best_u)
            best_v = jnp.where(better, tv, best_v)

        nxt = jnp.where(box_hit, mesh.hit_next[ni], mesh.miss_next[ni])
        node = jnp.where(live, nxt, node)
        out = (step + 1, node, best_t, best_tri, best_u, best_v)
        if track:
            out = out + (thick_t, thick_f)
        return out

    init = (
        jnp.int32(0),
        jnp.zeros((n,), I32),
        jnp.asarray(tmax, F32) * jnp.ones((n,), F32),
        jnp.zeros((n,), I32),
        jnp.zeros((n,), F32),
        jnp.zeros((n,), F32),
    )
    if track:
        init = init + (jnp.full((n,), big, F32), jnp.zeros((n,), bool))
    out = jax.lax.while_loop(cond, body, init)
    if track:
        _, _, best_t, best_tri, best_u, best_v, thick_t, thick_f = out
    else:
        _, _, best_t, best_tri, best_u, best_v = out
        thick_t = thick_f = None
    hit = best_t < jnp.asarray(tmax, F32) * 0.9999
    return TriHit(hit=hit, t=best_t, tri=best_tri, u=best_u, v=best_v,
                  inst=mesh.inst[best_tri], thick_hit=thick_f, thick_t=thick_t)


def traverse_shadow(mesh: MeshArrays, o, d, max_dist, absorb_scale=1.0,
                    max_steps: Optional[int] = None, blocked0=None):
    """Shadow traversal: accumulate transmission over every triangle crossed
    (AnyHit_Shadow_Triangle, AnyHit_Shadow.hlsl:60-88).

    absorb_scale = SHADOW_ABSORPTION_THICKNESS * Scene.ShadowAbsorptionScale.
    blocked0 [N] bool: lanes whose search already ended on an opaque
    analytic hit (AcceptHitAndEndSearch ends the WHOLE search) — their walk
    terminates at step 0.
    Returns (visibility [N], color [N,3], occluder_distance [N]).
    """
    n = o.shape[0]
    if max_steps is None:
        max_steps = mesh.num_nodes + 1
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    tmin = jnp.full((n,), C.RAY_TMIN, F32)
    pk = _plane_table(mesh.v0, mesh.edge1, mesh.edge2)
    num_inst = int(mesh.inst_transmission.shape[0])
    if num_inst <= 8:
        return _traverse_shadow_counts(mesh, o, d, max_dist, absorb_scale,
                                       max_steps, blocked0, pk, inv_d, tmin,
                                       num_inst)

    def cond(carry):
        step, node, vis, color, occ, blocked = carry
        return (step < max_steps) & jnp.any(node != _END)

    def body(carry):
        step, node, vis, color, occ, blocked = carry
        # Opaque hits END the search (AcceptHitAndEndSearch,
        # AnyHit_Shadow.hlsl:44-49,76-81): a blocked lane's walk terminates.
        node = jnp.where(blocked, _END, node)
        live = node != _END
        ni = jnp.clip(node, 0, mesh.num_nodes - 1)
        box_hit = live & _ray_aabb(o, inv_d, mesh.bbox_min[ni], mesh.bbox_max[ni], tmin, max_dist)
        count = mesh.tri_count[ni]
        start = mesh.tri_start[ni]
        do_leaf = box_hit & (count > 0)
        for k in range(LEAF_SIZE):
            ti = jnp.clip(start + k, 0, mesh.num_tris - 1)
            valid = do_leaf & (k < count)
            th, tt, _, _ = _tri_hit_plane_row(o, d, pk[ti], tmin, max_dist)
            th = th & valid
            inst = mesh.inst[ti]
            trans = mesh.inst_transmission[inst]
            absorb = mesh.inst_absorption[inst]
            opaque = th & (trans < 0.01)
            blocked = blocked | opaque
            translucent = th & (trans >= 0.01)
            vis = jnp.where(translucent, vis * trans, vis)
            # Beer tint exp(-sigmaA * thickness * scale) per crossing, but
            # only when the instance has absorption (AnyHit_Shadow.hlsl:84)
            has_ab = jnp.any(absorb > 0.0, axis=-1)
            beer = jnp.where(has_ab[:, None], jnp.exp(-absorb * absorb_scale), 1.0)
            color = jnp.where(translucent[:, None], color * beer, color)
            occ = jnp.where(th, jnp.minimum(occ, tt), occ)
        nxt = jnp.where(box_hit, mesh.hit_next[ni], mesh.miss_next[ni])
        node = jnp.where(live, nxt, node)
        return step + 1, node, vis, color, occ, blocked

    init = (
        jnp.int32(0),
        jnp.zeros((n,), I32),
        jnp.ones((n,), F32),
        jnp.ones((n, 3), F32),
        jnp.full((n,), C.NRD_FP16_MAX, F32),
        jnp.zeros((n,), bool) if blocked0 is None else blocked0,
    )
    _, _, vis, color, occ, blocked = jax.lax.while_loop(cond, body, init)
    vis = jnp.where(blocked, 0.0, vis)
    color = jnp.where(blocked[:, None], 0.0, color)
    return vis, color, occ


def _pow_u8(base, n_vec, one):
    """base ** n for integer n in [0,255] by repeated squaring — pure
    multiplies, so every backend rounds the same way."""
    r = one
    b = base
    for bit in range(8):
        r = jnp.where(((n_vec >> bit) & 1) != 0, r * b, r)
        if bit < 7:
            b = b * b
    return r


def _traverse_shadow_counts(mesh, o, d, max_dist, absorb_scale, max_steps,
                            blocked0, pk, inv_d, tmin, num_inst):
    """Count-based shadow traversal (<=8 instances): per-crossing factors
    are per-instance constants, so the walk packs per-instance crossing COUNTS into i32
    words (8 bits/instance) and evaluates vis = prod trans_i^n_i,
    color = prod beer_i^n_i once at walk end by repeated squaring."""
    n = o.shape[0]
    n_words = (num_inst + 3) // 4
    trans_i = mesh.inst_transmission  # [I]
    has_ab = jnp.any(mesh.inst_absorption > 0.0, axis=-1)
    beer_i = jnp.where(has_ab[:, None],
                       jnp.exp(-mesh.inst_absorption * absorb_scale), 1.0)  # [I,3]
    opq = (trans_i < 0.01)  # [I] bool

    def cond(carry):
        return (carry[0] < max_steps) & jnp.any(carry[1] != _END)

    def body(carry):
        step, node, occ, blocked = carry[0], carry[1], carry[2], carry[3]
        cnts = list(carry[4:])
        node = jnp.where(blocked, _END, node)
        live = node != _END
        ni = jnp.clip(node, 0, mesh.num_nodes - 1)
        box_hit = live & _ray_aabb(o, inv_d, mesh.bbox_min[ni], mesh.bbox_max[ni],
                                   tmin, max_dist)
        count = mesh.tri_count[ni]
        start = mesh.tri_start[ni]
        do_leaf = box_hit & (count > 0)
        for k in range(LEAF_SIZE):
            ti = jnp.clip(start + k, 0, mesh.num_tris - 1)
            valid = do_leaf & (k < count)
            th, tt, _, _ = _tri_hit_plane_row(o, d, pk[ti], tmin, max_dist)
            th = th & valid
            th_i = th.astype(I32)
            inst = mesh.inst[ti]
            blocked = blocked | (th & opq[inst])
            if n_words == 1:
                cnts[0] = cnts[0] + (th_i << (inst * 8))
            else:
                inc = th_i << ((inst & 3) * 8)
                hi = inst >= 4
                cnts[0] = cnts[0] + jnp.where(hi, 0, inc)
                cnts[1] = cnts[1] + jnp.where(hi, inc, 0)
            occ = jnp.where(th, jnp.minimum(occ, tt), occ)
        nxt = jnp.where(box_hit, mesh.hit_next[ni], mesh.miss_next[ni])
        node = jnp.where(live, nxt, node)
        return (step + 1, node, occ, blocked, *cnts)

    init = (
        jnp.int32(0),
        jnp.zeros((n,), I32),
        jnp.full((n,), C.NRD_FP16_MAX, F32),
        jnp.zeros((n,), bool) if blocked0 is None else blocked0,
        *([jnp.zeros((n,), I32)] * n_words),
    )
    out = jax.lax.while_loop(cond, body, init)
    occ, blocked = out[2], out[3]
    cnts = out[4:]

    one = jnp.ones((n,), F32)
    vis = one
    cr = one
    cg = one
    cb = one
    for i in range(num_inst):
        word = cnts[i // 4]
        n_i = (word >> ((i & 3) * 8)) & 255
        # Opaque instances contribute via `blocked` only (keep 0^n out of
        # the translucent product).
        n_i = jnp.where(opq[i], 0, n_i)
        vis = vis * _pow_u8(trans_i[i], n_i, one)
        cr = cr * _pow_u8(beer_i[i, 0], n_i, one)
        cg = cg * _pow_u8(beer_i[i, 1], n_i, one)
        cb = cb * _pow_u8(beer_i[i, 2], n_i, one)
    vis = jnp.where(blocked, 0.0, vis)
    color = jnp.where(blocked[:, None], 0.0, jnp.stack([cr, cg, cb], axis=-1))
    return vis, color, occ


def traverse_thickness(mesh: MeshArrays, o, d, inst_id, max_steps: Optional[int] = None):
    """Same-instance thickness hit (AnyHit_Thickness_Triangle.hlsl:111-129).

    The reference's any-hit calls AcceptHitAndEndSearch on the FIRST
    same-object hit traversal reaches — NOT the nearest. We match that
    end-search semantics deterministically: the walk stops at the first
    threaded-order leaf that yields any same-instance hit and returns the
    nearest hit within it.
    """
    n = o.shape[0]
    if max_steps is None:
        max_steps = mesh.num_nodes + 1
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    tmin = jnp.full((n,), C.RAY_TMIN, F32)
    big = jnp.float32(C.NRD_FP16_MAX)
    pk = _plane_table(mesh.v0, mesh.edge1, mesh.edge2)

    def cond(carry):
        step, node, best_t, found = carry
        return (step < max_steps) & jnp.any(node != _END)

    def body(carry):
        step, node, best_t, found = carry
        node = jnp.where(found, _END, node)
        live = node != _END
        ni = jnp.clip(node, 0, mesh.num_nodes - 1)
        box_hit = live & _ray_aabb(o, inv_d, mesh.bbox_min[ni], mesh.bbox_max[ni], tmin, best_t)
        count = mesh.tri_count[ni]
        start = mesh.tri_start[ni]
        do_leaf = box_hit & (count > 0)
        hit_leaf = jnp.zeros((n,), bool)
        for k in range(LEAF_SIZE):
            ti = jnp.clip(start + k, 0, mesh.num_tris - 1)
            valid = do_leaf & (k < count) & (mesh.inst[ti] == inst_id)
            th, tt, _, _ = _tri_hit_plane_row(o, d, pk[ti], tmin, best_t)
            th = th & valid
            better = th & (tt < best_t)
            best_t = jnp.where(better, tt, best_t)
            hit_leaf = hit_leaf | th
        nxt = jnp.where(box_hit, mesh.hit_next[ni], mesh.miss_next[ni])
        node = jnp.where(live, nxt, node)
        return step + 1, node, best_t, found | hit_leaf

    init = (jnp.int32(0), jnp.zeros((n,), I32), jnp.full((n,), big, F32),
            jnp.zeros((n,), bool))
    _, _, best_t, _ = jax.lax.while_loop(cond, body, init)
    hit = best_t < big * 0.999
    return hit, jnp.where(hit, best_t, big)


def shading_normal(mesh: MeshArrays, hit: TriHit, direction):
    """Triangle shading normal (ClosestHit_Triangle.hlsl:14-136).

    Barycentric-interpolated smooth normal, flipped to the geometric
    front-face side for robust thin-shell behavior.
    """
    ti = hit.tri
    w = 1.0 - hit.u - hit.v
    n = (
        mesh.n0[ti] * w[:, None]
        + mesh.n1[ti] * hit.u[:, None]
        + mesh.n2[ti] * hit.v[:, None]
    )
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    geo = jnp.cross(mesh.edge1[ti], mesh.edge2[ti])
    geo = geo / jnp.maximum(jnp.linalg.norm(geo, axis=-1, keepdims=True), 1e-12)
    # front face decided by the geometric normal (thin shells); the caller
    # applies N = frontFace ? n : -n (ClosestHit_Triangle.hlsl:124-126)
    front = jnp.sum(direction * geo, axis=-1) < 0.0
    return n, front
