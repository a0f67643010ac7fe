"""Minimal dependency-free PNG IO (stdlib zlib): 8-bit RGB.

The port's own copy of `ray_tracer_tpu/io/png.py`.

The reference emits binary PPM only (Serial/raytracer.cpp:178-185);
PNG is a production convenience for sharing renders.  PPM remains the
golden parity format — both writers share ppm.tonemap_u8's exact
min(1, c/255) truncating clamp, so the pixel bytes are identical.
Writes filter-0 rows; the reader handles all five standard row filters
on NON-interlaced 8-bit RGB/RGBA files (enough to round-trip our own
output and read common tool output; Adam7 interlacing is rejected
with a clear error).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ray_tracer_tpu_torch.io.ppm import tonemap_u8

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, already_u8: bool = False) -> None:
    """(H,W,3) float linear color (or uint8) -> 8-bit RGB PNG."""
    u8 = np.asarray(image, np.uint8) if already_u8 else tonemap_u8(image)
    if u8.ndim != 3 or u8.shape[2] != 3:
        raise ValueError(f"expected (H,W,3), got {u8.shape}")
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    with open(path, "wb") as fh:
        fh.write(_SIG)
        fh.write(_chunk(b"IHDR", ihdr))
        fh.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """8-bit RGB (or RGBA, alpha dropped) PNG -> (H,W,3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    idx, w = 8, None
    idat = b""
    while idx < len(data):
        (n,) = struct.unpack(">I", data[idx : idx + 4])
        tag = data[idx + 4 : idx + 8]
        body = data[idx + 8 : idx + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype not in (2, 6):
                raise ValueError(f"unsupported PNG (depth={depth} type={ctype})")
            if body[12]:
                # Adam7 passes would be misparsed as sequential rows
                raise ValueError("interlaced PNG unsupported")
            ch = 3 if ctype == 2 else 4
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        idx += 12 + n
    if w is None:
        raise ValueError("PNG missing IHDR")
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    for y in range(h):
        f = raw[y * (stride + 1)]
        row = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).copy()
        up = out[y - 1] if y else np.zeros(stride, np.uint8)
        if f == 0:
            out[y] = row
        elif f == 2:  # Up
            out[y] = row + up
        else:  # Sub/Average/Paeth need the left neighbor: scan per pixel
            cur = np.zeros(stride, np.uint8)
            for x in range(stride):
                a = int(cur[x - ch]) if x >= ch else 0
                b = int(up[x])
                c = int(up[x - ch]) if x >= ch else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                elif f == 4:
                    p = a + b - c  # Paeth, pure ints (scalar hot loop)
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c
                    )
                else:
                    raise ValueError(f"bad PNG filter {f}")
                cur[x] = (int(row[x]) + pred) & 0xFF  # mod-256 per spec
            out[y] = cur
    return out.reshape(h, w, ch)[:, :, :3]
