"""Binary-FBX container parsing vs the ASCII path (io/fbx.py).

The writer below is a test fixture generator: it serializes an
Objects/Geometry node tree in the "Kaydara FBX Binary" layout — both the
pre-7500 32-bit and the 7500+ 64-bit record formats, raw and zlib-deflate
arrays — which load_fbx must decode to the same ImportedMesh the ASCII
parser produces. This mirrors the reference's Assimp path accepting both
container flavors (MeshCacheService.cs:270-385; its own troubleshooting
text tells users to export "FBX 7.4 binary")."""
import os
import struct
import zlib

import numpy as np
import pytest

from raytracevs_tpu.io import fbx

_HEADER = fbx.BINARY_FBX_MAGIC + b"  \x00\x1a\x00"  # 23 bytes


def _prop_bytes(p, compress):
    if isinstance(p, str):
        b = p.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(p, np.ndarray):
        ch, dt = {"float64": (b"d", "<f8"), "float32": (b"f", "<f4"),
                  "int32": (b"i", "<i4"), "int64": (b"l", "<i8")}[str(p.dtype)]
        raw = np.ascontiguousarray(p.astype(dt)).tobytes()
        if compress:
            comp = zlib.compress(raw)
            return ch + struct.pack("<III", p.size, 1, len(comp)) + comp
        return ch + struct.pack("<III", p.size, 0, len(raw)) + raw
    if isinstance(p, bool):
        return b"C" + struct.pack("<B", int(p))
    if isinstance(p, int):
        return b"L" + struct.pack("<q", p)
    return b"D" + struct.pack("<d", float(p))


def _write_node(node, off, wide, compress):
    head_fmt = "<QQQ" if wide else "<III"
    sentinel = 25 if wide else 13
    name = node.name.encode()
    props = b"".join(_prop_bytes(p, compress) for p in node.props)
    head_len = struct.calcsize(head_fmt) + 1 + len(name)
    k_off = off + head_len + len(props)
    kids = b""
    for c in node.children:
        kb = _write_node(c, k_off, wide, compress)
        kids += kb
        k_off += len(kb)
    if node.children:
        kids += b"\x00" * sentinel
        k_off += sentinel
    return (struct.pack(head_fmt, k_off, len(node.props), len(props))
            + bytes([len(name)]) + name + props + kids)


def write_binary_fbx(root, version=7400, compress=False):
    """Serialize a fbx._Node tree as a Kaydara FBX Binary byte string."""
    wide = version >= 7500
    out = _HEADER + struct.pack("<I", version)
    off = len(out)
    for c in root.children:
        nb = _write_node(c, off, wide, compress)
        out += nb
        off += len(nb)
    return out + b"\x00" * (25 if wide else 13)


def _tree(geometries):
    """Objects>Geometry[] tree from [(verts [V,3] f64, poly_idx i32)]."""
    objects = fbx._Node("Objects", [])
    for gi, (verts, poly) in enumerate(geometries):
        g = fbx._Node("Geometry", [1000 + gi, f"Geometry::g{gi}", "Mesh"])
        g.children.append(fbx._Node(
            "Vertices", [np.asarray(verts, np.float64).reshape(-1)]))
        g.children.append(fbx._Node(
            "PolygonVertexIndex", [np.asarray(poly, np.int32)]))
        objects.children.append(g)
    root = fbx._Node("", [])
    root.children.append(objects)
    return root


def _cube():
    verts = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.float64)
    # six quads, each closed by a bit-complemented final index
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    poly = []
    for q in quads:
        poly += [q[0], q[1], q[2], ~q[3]]
    return verts, np.asarray(poly, np.int32)


def _cube_ascii():
    verts, poly = _cube()
    v = ",".join(f"{x:.6f}" for x in verts.reshape(-1))
    i = ",".join(str(x) for x in poly)
    return (
        "; FBX 7.3.0 project file\n"
        "Objects: {\n"
        '  Geometry: 1000, "Geometry::g0", "Mesh" {\n'
        f"    Vertices: *{verts.size} {{ a: {v} }}\n"
        f"    PolygonVertexIndex: *{poly.size} {{ a: {i} }}\n"
        "  }\n"
        "}\n"
    )


@pytest.mark.parametrize("version", [7400, 7500])
@pytest.mark.parametrize("compress", [False, True])
def test_binary_cube_matches_ascii(tmp_path, version, compress):
    verts, poly = _cube()
    bpath = tmp_path / "cube_bin.fbx"
    bpath.write_bytes(write_binary_fbx(_tree([(verts, poly)]),
                                       version=version, compress=compress))
    apath = tmp_path / "cube_ascii.fbx"
    apath.write_text(_cube_ascii())

    mb = fbx.load_fbx(str(bpath))
    ma = fbx.load_fbx(str(apath))
    np.testing.assert_array_equal(mb.vertices, ma.vertices)
    np.testing.assert_array_equal(mb.indices, ma.indices)
    np.testing.assert_array_equal(mb.normals, ma.normals)
    assert mb.indices.size == 6 * 2 * 3  # quads fan-triangulated
    assert len(mb.vertices) == 8  # welded


def test_binary_scalar_property_types(tmp_path):
    """Every scalar/array property type decodes (and is skipped cleanly
    when not geometry)."""
    root = _tree([_cube()])
    meta = fbx._Node("Meta", [True, 7, "name", 1.5])
    meta.children.append(fbx._Node("Arr", [np.arange(4, dtype=np.int64)]))
    root.children[0].children.append(meta)
    p = tmp_path / "meta.fbx"
    p.write_bytes(write_binary_fbx(root))
    m = fbx.load_fbx(str(p))
    assert len(m.vertices) == 8


def test_binary_wineglass_matches_ascii(tmp_path):
    """The real reference asset, re-containered: binary parse == ASCII
    parse on the full 5.9k-triangle WineGlass geometry."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "WineGlass.fbx")  # not shipped: add it to run
    with open(src, "r", encoding="utf-8", errors="replace") as f:
        root = fbx._parse_ascii_fbx(f.read())
    geoms = []
    for geo in root.find("Objects").find_all("Geometry"):
        verts = fbx._collect_array(geo.find("Vertices"))
        poly = fbx._collect_array(geo.find("PolygonVertexIndex"))
        geoms.append((verts, poly.astype(np.int64).astype(np.int32)))
    assert geoms
    p = tmp_path / "wineglass_bin.fbx"
    p.write_bytes(write_binary_fbx(_tree(geoms), version=7500, compress=True))

    mb = fbx.load_fbx(str(p))
    ma = fbx.load_fbx(src)
    np.testing.assert_array_equal(mb.vertices, ma.vertices)
    np.testing.assert_array_equal(mb.indices, ma.indices)
    np.testing.assert_array_equal(mb.normals, ma.normals)
