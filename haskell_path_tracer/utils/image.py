"""Image output: tonemap + PNG/PPM writers.

Replaces the reference's display path — the OpenGL fragment shader that
divides the accumulator by the iteration count at display time
(upstream app/assets/fs.glsl:12) and the SDL window
(the reference's app/Main.hs:326-408).  On a headless host there is no window;
the accumulator is normalized on device (`Accumulator.image`), tonemapped,
and written to disk.  A native C++ encoder (runtime/native) is used when
built (the reference hit ~200 ms on naive host-side pixel conversion,
app/Main.hs:378-381 — the C path exists for the same reason); this module
always provides the pure-Python fallback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(image: np.ndarray, exposure: float = 1.0, gamma: float = 2.2) -> np.ndarray:
    """HDR radiance -> display: exposure scale, Reinhard, gamma. uint8 [H,W,3].

    The reference displays raw averaged radiance (fs.glsl:12 does only the
    division); `gamma=1.0, reinhard=False` reproduces that.  Defaults give a
    usable LDR image.
    """
    x = np.asarray(image, np.float32) * np.float32(exposure)
    x = x / (1.0 + x)  # Reinhard
    x = np.clip(x, 0.0, 1.0) ** np.float32(1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """Minimal dependency-free PNG encoder (8-bit RGB) -> bytes."""
    h, w, c = rgb8.shape
    assert c == 3 and rgb8.dtype == np.uint8

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    # filter type 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb8.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb8))


def _exr_zip_pack(raw: bytes) -> bytes:
    """OpenEXR's zip pre-filter + deflate (ImfZip.cpp semantics):
    interleave-split the byte stream into two halves, delta-encode with a
    +128 bias, then zlib.  The filter exploits the byte-plane coherence of
    little-endian half/float scanlines."""
    a = np.frombuffer(raw, np.uint8)
    n = a.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    d = t.astype(np.int16)
    d[1:] -= t[:-1].astype(np.int16) - 128
    return zlib.compress(d.astype(np.uint8).tobytes())


def _exr_zip_unpack(packed: bytes, raw_size: int) -> bytes:
    """Inverse of `_exr_zip_pack`."""
    t = np.frombuffer(zlib.decompress(packed), np.uint8)
    assert t.size == raw_size, (t.size, raw_size)
    # Undo the delta: out[i] = out[i-1] + in[i] - 128 (mod 256).
    u = t.astype(np.int64)
    u[1:] -= 128
    out = np.cumsum(u) % 256
    t = out.astype(np.uint8)
    half = (raw_size + 1) // 2
    a = np.empty(raw_size, np.uint8)
    a[0::2] = t[:half]
    a[1::2] = t[half:]
    return a.tobytes()


# EXR compression codes.
_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_BLOCK_LINES = {_EXR_NONE: 1, _EXR_ZIPS: 1, _EXR_ZIP: 16}
_EXR_PIXEL_SIZE = {1: 2, 2: 4}  # HALF, FLOAT


def write_exr(
    path: str,
    image: np.ndarray,
    compression: str = "zip",
    half: bool = False,
) -> None:
    """OpenEXR 2.0 writer: single part, scanline, B/G/R channels.

    `compression`: "none", "zips" (per-line deflate) or "zip" (16-line
    blocks, the OpenEXR default — typically 2-3x smaller on rendered
    images).  `half=True` writes IEEE half-float channels (the industry
    default for radiance interchange); False full float32.  HDR radiance
    goes to disk unclamped — the analog of the reference's raw
    accumulator texture (its tonemapping lived in the display shader,
    upstream app/assets/fs.glsl:12), but in a format downstream
    tools read."""
    comp = {"none": _EXR_NONE, "zips": _EXR_ZIPS, "zip": _EXR_ZIP}[
        compression
    ]
    ptype = 1 if half else 2
    dtype = np.float16 if half else np.float32
    img = np.asarray(image, np.float32).astype(dtype)
    h, w, c = img.shape
    assert c == 3

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<I", len(data)) + data

    def chan(name: bytes) -> bytes:
        # name, pixel_type, pLinear + 3 reserved, x/y sampling
        return name + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)

    channels = chan(b"B") + chan(b"G") + chan(b"R") + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<I", 20000630)  # magic
        + struct.pack("<I", 2)  # version 2, no flags
        + attr(b"channels", b"chlist", channels)
        + attr(b"compression", b"compression", bytes([comp]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"  # end of header
    )
    lines_per_block = _EXR_BLOCK_LINES[comp]
    blocks = []
    for y0 in range(0, h, lines_per_block):
        y1 = min(y0 + lines_per_block, h)
        # Per scanline, channels in header (alphabetical) order: B, G, R.
        rows = [
            np.ascontiguousarray(img[y, :, ch]).tobytes()
            for y in range(y0, y1)
            for ch in (2, 1, 0)
        ]
        raw = b"".join(rows)
        if comp == _EXR_NONE:
            data = raw
        else:
            data = _exr_zip_pack(raw)
            if len(data) >= len(raw):  # OpenEXR rule: store raw if bigger
                data = raw
        blocks.append((y0, data))

    table_start = len(header)
    data_start = table_start + 8 * len(blocks)
    offsets, pos = [], data_start
    for _, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack("<%dQ" % len(blocks), *offsets))
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def read_exr(path: str) -> np.ndarray:
    """General single-part scanline EXR reader: NO/ZIPS/ZIP compression,
    HALF or FLOAT channels in any header order.  Returns [H, W, 3] f32
    (R, G, B; missing channels read as 0)."""
    blob = open(path, "rb").read()
    magic, _version = struct.unpack("<II", blob[:8])
    assert magic == 20000630, "not an EXR file"
    pos = 8
    attrs = {}
    while blob[pos] != 0:
        end = blob.index(b"\0", pos)
        name = blob[pos:end].decode()
        pos = end + 1
        end = blob.index(b"\0", pos)
        pos = end + 1
        (size,) = struct.unpack("<I", blob[pos : pos + 4])
        pos += 4
        attrs[name] = blob[pos : pos + size]
        pos += size
    pos += 1  # header terminator
    x0, y0_, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0_ + 1
    comp = attrs["compression"][0]
    assert comp in _EXR_BLOCK_LINES, f"unsupported EXR compression {comp}"

    # Parse the channel list: (name, pixel_type) in file order.
    chans, cpos = [], 0
    cl = attrs["channels"]
    while cl[cpos] != 0:
        cend = cl.index(b"\0", cpos)
        cname = cl[cpos:cend].decode()
        ptype = struct.unpack("<i", cl[cend + 1 : cend + 5])[0]
        assert ptype in _EXR_PIXEL_SIZE, f"unsupported pixel type {ptype}"
        chans.append((cname, ptype))
        cpos = cend + 1 + 16
    line_bytes = sum(w * _EXR_PIXEL_SIZE[t] for _, t in chans)

    lines_per_block = _EXR_BLOCK_LINES[comp]
    n_blocks = -(-h // lines_per_block)
    pos += 8 * n_blocks  # offset table

    img = np.zeros((h, w, 3), np.float32)
    rgb = {"R": 0, "G": 1, "B": 2}
    for _ in range(n_blocks):
        by, size = struct.unpack("<ii", blob[pos : pos + 8])
        pos += 8
        data = blob[pos : pos + size]
        pos += size
        n_lines = min(lines_per_block, h - (by - y0_))
        raw_size = line_bytes * n_lines
        raw = (
            data
            if (comp == _EXR_NONE or size == raw_size)
            else _exr_zip_unpack(data, raw_size)
        )
        off = 0
        for li in range(n_lines):
            for cname, ptype in chans:
                nb = w * _EXR_PIXEL_SIZE[ptype]
                if cname in rgb:
                    dt = np.float16 if ptype == 1 else np.float32
                    img[by - y0_ + li, :, rgb[cname]] = np.frombuffer(
                        raw[off : off + nb], dt
                    ).astype(np.float32)
                off += nb
    return img


def write_ppm(path: str, rgb8: np.ndarray) -> None:
    """Trivial PPM writer (debugging)."""
    h, w, _ = rgb8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb8.tobytes())


def save_render(path: str, image, exposure: float = 1.0, gamma: float = 2.2):
    """Tonemap a normalized radiance image and write PNG (or PPM by suffix).

    The accumulator's row 0 carries the *downward*-tilted primary rays
    (the reference's array layout: screenY=+1 -> topOffset points to -y,
    upstream src/Scene/Trace.hs:234-253).  The reference displays
    that array through an OpenGL texture whose v=0 row lands at the
    *bottom* of the window (upstream app/Main.hs:382-393 +
    app/assets/vs.glsl), so its window shows the world upright; file
    formats put row 0 at the top, so flip vertically here — the display
    boundary — to match what a reference user saw.  Array-level parity
    (tests, oracles) is unaffected.

    Uses the native C++ tonemap + encoder (runtime/native) when built; the
    pure-Python path above is the always-available fallback and the
    behavioral spec the native path is tested against."""
    from ..runtime import native

    img = np.asarray(image)[::-1]
    if path.endswith(".exr"):
        # HDR: raw radiance, no tonemap.
        write_exr(path, img)
        return path
    if native.available():
        rgb8 = native.tonemap_rgb8(
            np.ascontiguousarray(img, np.float32), exposure, gamma
        )
        if not path.endswith(".ppm"):
            native.write_png(path, rgb8)
            return path
    else:
        rgb8 = tonemap(img, exposure=exposure, gamma=gamma)
    if path.endswith(".ppm"):
        write_ppm(path, rgb8)
    else:
        write_png(path, rgb8)
    return path
