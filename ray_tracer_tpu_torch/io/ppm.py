"""Binary PPM (P6) image IO with the reference's exact tone clamp.

The port's own copy of `ray_tracer_tpu/io/ppm.py`.  The reference writes
min(1, c/255)*255 per channel as unsigned char
(Serial/raytracer.cpp:178-185); the C cast truncates toward zero, and
`tonemap_u8` reproduces that truncation.
"""

from __future__ import annotations

import numpy as np


def tonemap_u8(image: np.ndarray) -> np.ndarray:
    """(H,W,3) float linear color -> (H,W,3) uint8 with the reference clamp."""
    img = np.asarray(image, dtype=np.float32)
    scaled = np.minimum(np.float32(1.0), img / np.float32(255.0)) * np.float32(255.0)
    return scaled.astype(np.uint8)  # C-style truncation


def write_ppm(path: str, image: np.ndarray, already_u8: bool = False) -> None:
    u8 = np.asarray(image, dtype=np.uint8) if already_u8 else tonemap_u8(image)
    h, w = u8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(u8.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM into an (H,W,3) uint8 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    # header: magic, width, height, maxval, whitespace-separated, with
    # '#' comments skipped
    fields = []
    idx = 0
    while len(fields) < 4:
        while data[idx : idx + 1].isspace():
            idx += 1
        if data[idx : idx + 1] == b"#":
            while data[idx : idx + 1] not in (b"\n", b""):
                idx += 1
            continue
        start = idx
        while not data[idx : idx + 1].isspace():
            idx += 1
        fields.append(data[start:idx])
    if fields[0] != b"P6":
        raise ValueError(f"not a binary PPM: {fields[0]!r}")
    w, h, maxval = int(fields[1]), int(fields[2]), int(fields[3])
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    idx += 1  # single whitespace after maxval
    pixels = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=idx)
    return pixels.reshape(h, w, 3).copy()
