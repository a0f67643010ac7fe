"""The port's PNG IO (ray_tracer_tpu_torch/io/png.py) against the JAX
package's (ray_tracer_tpu/io/png.py): `write_png` gives JAX's bytes, for
float images through the reference's tone clamp and for uint8 images;
`read_png` round-trips them, and decodes every row filter (None, Sub, Up,
Average, Paeth) of RGB and RGBA files as JAX's reader does; both refuse
interlaced files and files that are not PNG."""

import struct
import zlib

import numpy as np
import pytest

from ray_tracer_tpu.io import png as jax_png
from ray_tracer_tpu_torch.io import png
from ray_tracer_tpu_torch.io.ppm import tonemap_u8

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (32, 24)])
def test_write_png_bytes_equal_jax(tmp_path, h, w):
    img = (RNG.random((h, w, 3)) * 300.0).astype(np.float32)
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    png.write_png(str(ours), img)
    jax_png.write_png(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(png.read_png(str(ours)), tonemap_u8(img))
    u8 = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    png.write_png(str(ours), u8, already_u8=True)
    jax_png.write_png(str(theirs), u8, already_u8=True)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(png.read_png(str(ours)), u8)


def _png_bytes(rows: np.ndarray, filters, ctype: int, interlace: int = 0) -> bytes:
    """A PNG whose row y carries filter byte filters[y] over rows[y]."""
    h, stride = rows.shape
    ch = 3 if ctype == 2 else 4
    raw = b"".join(bytes([int(f)]) + rows[y].tobytes() for y, f in enumerate(filters))
    ihdr = struct.pack(">IIBBBBB", stride // ch, h, 8, ctype, 0, 0, interlace)
    return (png._SIG + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [2, 6])
def test_read_png_decodes_every_filter_as_jax(tmp_path, ctype):
    ch = 3 if ctype == 2 else 4
    h, w = 10, 9
    rows = RNG.integers(0, 256, size=(h, w * ch), dtype=np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_bytes(rows, [y % 5 for y in range(h)], ctype))
    got = png.read_png(str(path))
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_png.read_png(str(path)))
    # filter 0 rows decode to themselves (alpha dropped)
    np.testing.assert_array_equal(got[0], rows[0].reshape(w, ch)[:, :3])


def test_read_png_refuses_what_jax_refuses(tmp_path):
    rows = RNG.integers(0, 256, size=(2, 6), dtype=np.uint8)
    interlaced = tmp_path / "adam7.png"
    interlaced.write_bytes(_png_bytes(rows, [0, 0], 2, interlace=1))
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    for path, match in ((interlaced, "interlaced"), (not_png, "not a PNG")):
        for reader in (png.read_png, jax_png.read_png):
            with pytest.raises(ValueError, match=match):
                reader(str(path))
    with pytest.raises(ValueError, match="expected"):
        png.write_png(str(tmp_path / "bad.png"), np.zeros((2, 2, 4), np.float32))
