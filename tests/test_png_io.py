"""PNG reader + blue-noise asset parity (RayGen.hlsl:9-15, DXRPipeline.cpp:1517-1613)."""
import numpy as np


def test_png_read_write_roundtrip(tmp_path):
    from raytracevs_tpu.io.png import read_png, write_png

    rng = np.random.RandomState(7)
    for channels in (1, 3, 4):
        a = rng.randint(0, 256, (9, 13, channels), dtype=np.uint8)
        p = str(tmp_path / f"rt{channels}.png")
        write_png(p, a)
        b = read_png(p)
        assert np.array_equal(a, b)


def test_png_reader_handles_all_filters(tmp_path):
    # zlib level 9 + a gradient image makes the encoder in PIL (if present)
    # pick varied filters; our own writer always uses filter 0, so also
    # hand-craft rows with filters 1-4.
    import struct
    import zlib

    from raytracevs_tpu.io.png import read_png

    w, h = 8, 5
    img = (np.arange(w * h * 3, dtype=np.uint32) * 37 % 256).astype(np.uint8)
    img = img.reshape(h, w, 3)

    # Encode each row with a different filter type and check decode.
    def filt_row(cur, prev, ftype, bpp=3):
        cur = cur.astype(np.int32)
        prev = prev.astype(np.int32)
        out = np.zeros_like(cur)
        for x in range(len(cur)):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[x] = (cur[x] - pred) & 0xFF
        return out.astype(np.uint8)

    flat = img.reshape(h, w * 3)
    raw = b""
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        ftype = y % 5
        raw += bytes([ftype]) + filt_row(flat[y], prev, ftype).tobytes()
        prev = flat[y]

    def chunk(tag, data):
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    p = str(tmp_path / "filters.png")
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
    assert np.array_equal(read_png(p), img)


def test_blue_noise_tile_is_the_reference_asset():
    import os

    from raytracevs_tpu.io.png import read_png
    from raytracevs_tpu.ops import sampling

    tile = np.asarray(sampling.blue_noise_tile())
    assert tile.shape == (16, 16, 4)

    ref = os.path.join(os.path.dirname(sampling.__file__), os.pardir,
                       "resources", "BlueNoise16.png")
    px = read_png(ref).astype(np.float32) / np.float32(255.0)
    # bit-exact: same u8 source, same UNORM conversion
    assert np.array_equal(tile, px)
