"""Minimal self-contained OpenEXR scanline I/O (uncompressed, float32).

The reference writes 3-channel float EXR via the openexr crate
(``src/main.rs:1402-1419``). We implement the subset of the EXR 2.0 format the
renderer needs — single-part scanline images, NO_COMPRESSION, FLOAT channels —
with no external dependency, plus a matching reader for roundtrip tests.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR pixel type


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write (H,W,3) float32 RGB as an uncompressed scanline EXR."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("expected (H,W,3) RGB")
    H, W = rgb.shape[:2]

    # channel list, alphabetical as the format requires: B, G, R
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\x00"
        ch += struct.pack("<iBBBBii", _PIXEL_FLOAT, 0, 0, 0, 0, 1, 1)
    ch += b"\x00"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            _attr(b"channels", b"chlist", ch),
            _attr(b"compression", b"compression", b"\x00"),  # NO_COMPRESSION
            _attr(b"dataWindow", b"box2i", box),
            _attr(b"displayWindow", b"box2i", box),
            _attr(b"lineOrder", b"lineOrder", b"\x00"),  # INCREASING_Y
            _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
            _attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0)),
            _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(preamble)
    data_pos = table_pos + 8 * H
    line_bytes = 8 + 3 * W * 4  # y + size prefix + 3 channels of f32

    with open(path, "wb") as f:
        f.write(preamble)
        offsets = [data_pos + y * line_bytes for y in range(H)]
        f.write(struct.pack(f"<{H}Q", *offsets))
        bgr = rgb[:, :, ::-1]  # scanline stores channels in file order B,G,R
        for y in range(H):
            f.write(struct.pack("<ii", y, 3 * W * 4))
            f.write(np.ascontiguousarray(bgr[y].T).tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed float scanline EXR written by ``write_exr`` (or
    compatible). Returns (H,W,3) float32 RGB."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version = struct.unpack_from("<ii", raw, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels: list[str] = []
    data_window = None
    compression = None
    while raw[pos] != 0:
        end = raw.index(b"\x00", pos)
        name = raw[pos:end].decode()
        pos = end + 1
        end = raw.index(b"\x00", pos)
        typ = raw[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        data = raw[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while data[cp] != 0:
                ce = data.index(b"\x00", cp)
                cname = data[cp:ce].decode()
                (ptype,) = struct.unpack_from("<i", data, ce + 1)
                if ptype != _PIXEL_FLOAT:
                    raise NotImplementedError("only FLOAT channels supported")
                channels.append(cname)
                cp = ce + 1 + 16
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", data)
        elif name == "compression":
            compression = data[0]
    pos += 1  # header terminator
    if compression != 0:
        raise NotImplementedError("only NO_COMPRESSION supported")
    x0, y0, x1, y1 = data_window
    W, H = x1 - x0 + 1, y1 - y0 + 1
    offsets = struct.unpack_from(f"<{H}Q", raw, pos)
    img = np.zeros((H, len(channels), W), np.float32)
    for i, off in enumerate(offsets):
        y, size = struct.unpack_from("<ii", raw, off)
        line = np.frombuffer(raw, np.float32, count=len(channels) * W, offset=off + 8)
        img[y - y0] = line.reshape(len(channels), W)
    out = dict(zip(channels, img.transpose(1, 0, 2)))
    return np.stack([out["R"], out["G"], out["B"]], axis=-1)


def tonemap_srgb(rgb: np.ndarray) -> np.ndarray:
    """Linear -> sRGB, clamped to [0,1] (for PNG previews)."""
    rgb = np.clip(np.nan_to_num(np.asarray(rgb, np.float32)), 0.0, 1.0)
    lo = rgb * 12.92
    hi = 1.055 * np.power(rgb, 1.0 / 2.4, where=rgb > 0, out=np.zeros_like(rgb)) - 0.055
    return np.where(rgb <= 0.0031308, lo, hi)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write a tonemapped PNG preview (the winit live-preview replacement)."""
    from PIL import Image

    img = (tonemap_srgb(rgb) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(img, "RGB").save(path)
