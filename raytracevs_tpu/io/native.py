"""ctypes bindings for the native runtime library (csrc/rtvs_native.cpp).

The compute path is JAX; host-side runtime work that the reference
does in C++ (BVH builds standing in for driver BLAS builds, scene
checksums) has a native implementation here, with pure-numpy fallbacks when
the shared library can't be built. `load()` builds it with `make -C csrc`
on first use, for the host it runs on.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "csrc", "librtvs_native.so")


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building on demand) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.abspath(_lib_path())
    if not os.path.exists(path) and build_if_missing:
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.rtvs_build_bvh.restype = ctypes.c_int
    lib.rtvs_build_bvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.rtvs_fnv1a.restype = ctypes.c_uint64
    lib.rtvs_fnv1a.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    try:
        lib.rtvs_build_bvh_refs.restype = ctypes.c_int
        lib.rtvs_build_bvh_refs.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rtvs_presplit.restype = ctypes.c_int
        lib.rtvs_presplit.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
    except AttributeError:
        pass  # stale .so without the presplit entry points
    _LIB = lib
    return _LIB


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int):
    """Binned-SAH threaded BVH via the native builder.

    Returns (bbox_min, bbox_max, hit_next, miss_next, tri_start, tri_count,
    tri_order) or None when the library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    t = len(v0)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    cap = max(2 * t, 1)
    bbox_min = np.zeros((cap, 3), np.float32)
    bbox_max = np.zeros((cap, 3), np.float32)
    hit_next = np.zeros(cap, np.int32)
    miss_next = np.zeros(cap, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    tri_order = np.zeros(t, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n_nodes = lib.rtvs_build_bvh(
        fp(v0), fp(v1), fp(v2), t, leaf_size,
        fp(bbox_min), fp(bbox_max), ip(hit_next), ip(miss_next),
        ip(tri_start), ip(tri_count), ip(tri_order),
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return (bbox_min[s], bbox_max[s], hit_next[s], miss_next[s],
            tri_start[s], tri_count[s], tri_order)


def presplit_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                    budget_factor: float):
    """Pre-split sliver triangles into tighter reference boxes
    (Ernst-Greiner early split clipping in csrc).

    Returns (ref_tri [R]i32, ref_min [R,3]f32, ref_max [R,3]f32) or None.
    """
    lib = load()
    if lib is None or not hasattr(lib, "rtvs_presplit"):
        return None
    t = len(v0)
    max_refs = max(int(t * budget_factor), t)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    ref_tri = np.zeros(max_refs, np.int32)
    ref_min = np.zeros((max_refs, 3), np.float32)
    ref_max = np.zeros((max_refs, 3), np.float32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    n = lib.rtvs_presplit(
        fp(v0), fp(v1), fp(v2), t, max_refs,
        ref_tri.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        fp(ref_min), fp(ref_max),
    )
    if n <= 0:
        return None
    return ref_tri[:n], ref_min[:n], ref_max[:n]


def build_bvh_refs_native(ref_min: np.ndarray, ref_max: np.ndarray,
                          leaf_size: int):
    """Binned-SAH threaded BVH over explicit reference bounds.

    Returns (bbox_min, bbox_max, hit_next, miss_next, tri_start, tri_count,
    ref_order) or None when the library is unavailable.
    """
    lib = load()
    if lib is None or not hasattr(lib, "rtvs_build_bvh_refs"):
        return None
    r = len(ref_min)
    ref_min = np.ascontiguousarray(ref_min, np.float32)
    ref_max = np.ascontiguousarray(ref_max, np.float32)
    cap = max(2 * r, 1)
    bbox_min = np.zeros((cap, 3), np.float32)
    bbox_max = np.zeros((cap, 3), np.float32)
    hit_next = np.zeros(cap, np.int32)
    miss_next = np.zeros(cap, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    ref_order = np.zeros(r, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n_nodes = lib.rtvs_build_bvh_refs(
        fp(ref_min), fp(ref_max), r, leaf_size,
        fp(bbox_min), fp(bbox_max), ip(hit_next), ip(miss_next),
        ip(tri_start), ip(tri_count), ip(ref_order),
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return (bbox_min[s], bbox_max[s], hit_next[s], miss_next[s],
            tri_start[s], tri_count[s], ref_order)


def fnv1a(data: bytes) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(lib.rtvs_fnv1a(buf, len(data)))
