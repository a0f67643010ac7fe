"""Block-packed uniform grid: the production layout of the packed march.

The port's own copy of `ray_tracer_tpu/accel/packed.py`, built in numpy
on the host from the CSR grid and put on the device as tensors:

  * `blocks` (n_blocks, row_lanes) f32: each row packs `block_tris` whole
    triangles (9 floats each, slot-major [v0 v1 v2]); a voxel's triangle
    list is ceil(count / block_tris) consecutive rows, padded with
    all-zero triangles whose zero determinant fails the strict
    barycentric test.
  * `cell_info` (n_cells,) int32 holding the uint32 bits of the JAX
    package's per-voxel word (torch has no full uint32 support): bit 31
    clear = occupied, [spare:4 | n_blocks:6 | first_block:21]; bit 31 set
    = empty, six 5-bit extents of the cell's greedy maximal empty box.
  * `slot_tri` (n_blocks * block_tris,) i32: the triangle id of each
    (row, slot), -1 on padding.

With `inline=True` row `lin` IS cell lin's first row and its last two
lanes carry the header as bitcast int32 (overflow row or extents; row
count), so a march step reads one row; `cell_info` is a dummy (1,).

The empty boxes grow on the grid's device through
`accel/native.empty_boxes` (kernel G on the card, its plain version on
the CPU); the rows are assembled in host numpy.
`tests/test_torch_packed.py` pins the port's tables byte-equal to the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ray_tracer_tpu_torch.accel.grid import UniformGrid
from ray_tracer_tpu_torch.accel.native import (EXT_CAP, empty_boxes, empty_boxes_plain,
                                               pack_extents_words)
from ray_tracer_tpu_torch.device import resolve_device
from ray_tracer_tpu_torch.utils.timing import part

BLOCK_TRIS = 14  # default: 14 triangles * 9 floats = 126 of 128 lanes
DIST_CAP = 31  # Chebyshev-field cap (leap="cheb" reproduction mode)

_FIRST_BITS = 21
_NBLK_BITS = 6
_NBLK_SHIFT = _FIRST_BITS
_FIRST_MASK = (1 << _FIRST_BITS) - 1
_NBLK_MASK = (1 << _NBLK_BITS) - 1
_EMPTY_FLAG = np.uint32(1 << 31)


class PackedGridMeta(NamedTuple):
    n_voxels: Tuple[int, int, int]
    n_blocks: int
    probe_delta: float  # cell-probe nudge, in t units (directions are unit)
    block_tris: int = BLOCK_TRIS  # triangles per block row
    row_lanes: int = 128  # block row width (multiple of 128)
    max_blocks: int = 1  # largest per-voxel row count (march bound)
    inline: bool = False  # header in each cell's first row (one read a step)

    @property
    def total_voxels(self) -> int:
        nx, ny, nz = self.n_voxels
        return nx * ny * nz


class PackedGridArrays(NamedTuple):
    lower: torch.Tensor  # (3,) f32
    upper: torch.Tensor
    width: torch.Tensor  # (3,)
    inv_width: torch.Tensor
    cell_info: torch.Tensor  # (n_cells,) int32 = the uint32 bits
    blocks: torch.Tensor  # (n_blocks, row_lanes) f32
    slot_tri: torch.Tensor  # (n_blocks * block_tris,) i32


@dataclass(frozen=True)
class PackedGrid:
    arrays: PackedGridArrays
    meta: PackedGridMeta


def _decode_extents(word: torch.Tensor):
    """30-bit packed extents -> (lo (..., 3) i32, hi (..., 3) i32) in
    [x, y, z] order.  Only bits 0..29 are read."""
    w = word.to(torch.int32) & 0x3FFFFFFF
    lo = torch.stack([w & 31, (w >> 10) & 31, (w >> 20) & 31], dim=-1)
    hi = torch.stack([(w >> 5) & 31, (w >> 15) & 31, (w >> 25) & 31], dim=-1)
    return lo, hi


def decode_cell_info(info: torch.Tensor):
    """int32 (uint32 bits) -> (first_block, n_blocks, lo_ext, hi_ext).
    n_blocks is 0 exactly for empty cells (bit 31 set, i.e. negative as
    int32); occupied cells' extents are garbage, gated on n_blocks > 0."""
    info = info.to(torch.int32)
    empty = info < 0
    first = info & _FIRST_MASK
    nblk = torch.where(empty, torch.zeros_like(info), (info >> _NBLK_SHIFT) & _NBLK_MASK)
    lo, hi = _decode_extents(info)
    return first, nblk, lo, hi


def decode_inline_header(row: torch.Tensor):
    """Inline-layout row (..., row_lanes) f32 -> (overflow_first, n_rows,
    lo_ext, hi_ext): lane -1 is n_rows (0 = empty cell), lane -2 the first
    overflow row of an occupied cell or the packed extents of an empty
    one, both bitcast int32."""
    h0 = row[..., -2].contiguous().view(torch.int32)
    h1 = row[..., -1].contiguous().view(torch.int32)
    lo, hi = _decode_extents(h0)
    return h0, h1 & 0xFFFF, lo, hi


def greedy_empty_boxes(occupied: np.ndarray, cap: int = EXT_CAP) -> np.ndarray:
    """Per-cell maximal empty box of every EMPTY cell, by balanced greedy
    round-robin growth against a 3-D summed-area table (the JAX
    package's numpy path, ray_tracer_tpu/accel/packed.py:188-232), in
    numpy through the plain version `accel/native.empty_boxes_plain`.

    occupied: (nz, ny, nx) bool -> (6, nz, ny, nx) int32 extents
    [x-, x+, y-, y+, z-, z+]; cells outside the grid count as empty;
    occupied cells get zeros."""
    occ = torch.from_numpy(np.ascontiguousarray(occupied, dtype=bool))
    return empty_boxes_plain(occ, cap).numpy()


def pack_extents(ext: np.ndarray) -> np.ndarray:
    """(6, ...) int32 extents -> (...,) uint32, 5 bits per direction
    ([x-@0, x+@5, y-@10, y+@15, z-@20, z+@25]; kernel G's words)."""
    words = pack_extents_words(torch.from_numpy(np.ascontiguousarray(ext, np.int32)))
    return words.numpy().view(np.uint32)


def chebyshev_distance_field(occupied: np.ndarray, cap: int = DIST_CAP) -> np.ndarray:
    """Chebyshev (L-inf) distance to the nearest True cell, capped, by one
    3x3x3 max-dilation per ring."""
    dist = np.where(occupied, 0, cap).astype(np.int32)
    frontier = occupied.copy()
    for k in range(1, cap):
        if frontier.all():
            break
        grown = frontier.copy()
        for axis in range(3):
            shifted_fwd = np.roll(grown, 1, axis=axis)
            shifted_bwd = np.roll(grown, -1, axis=axis)
            # roll wraps; kill the wrapped slice
            sl_lo = [slice(None)] * 3
            sl_lo[axis] = 0
            sl_hi = [slice(None)] * 3
            sl_hi[axis] = -1
            shifted_fwd[tuple(sl_lo)] = False
            shifted_bwd[tuple(sl_hi)] = False
            grown = grown | shifted_fwd | shifted_bwd
        newly = grown & ~frontier
        dist[newly] = k
        frontier = grown
    return dist


def pack_grid(
    grid: UniformGrid,
    verts: np.ndarray,
    faces: np.ndarray,
    block_tris: int = BLOCK_TRIS,
    pad_meta: "PackedGridMeta | None" = None,
    as_numpy: bool = False,
    inline: bool = False,
    leap: str = "box",
) -> PackedGrid:
    """Build the packed layout from the CSR grid on the host and put it on
    the grid's device (ray_tracer_tpu/accel/packed.py:273-470).

    The row width is 9*block_tris (+2 header lanes inline) rounded up to
    a multiple of 128.  leap="box" builds greedy maximal empty boxes,
    "cheb" the symmetric Chebyshev cube; hits are the same either way.
    as_numpy keeps every array in host numpy (cell_info as its int32
    bits) for a caller that pads and stacks several packs before one
    upload (`parallel.shard.build_ring_grids`).  pad_meta (the JAX
    package's padding to a static meta for vertex-optimization rebuilds)
    is refused: the port has no jit to keep, and a rebuild is `prepare`
    at the built meta."""
    if pad_meta is not None:
        raise NotImplementedError(
            "pack_grid(pad_meta=...) is not served by the PyTorch port: a rebuild is "
            "prepare() at the built meta (ROADMAP.md)")
    row_lanes = -(-(block_tris * 9 + (2 if inline else 0)) // 128) * 128
    nx, ny, nz = grid.meta.n_voxels
    n_cells = nx * ny * nz
    host = grid.host
    cell_start = np.asarray(host.cell_start)
    tri_ids = np.asarray(host.tri_ids)
    # the JAX package's min_w, so that the f32 probe nudge is the same float
    min_w = float(np.min(host.width))
    counts = np.diff(cell_start).astype(np.int64)

    nblk = (counts + block_tris - 1) // block_tris
    if nblk.max(initial=0) > (0xFFFF if inline else _NBLK_MASK):
        raise ValueError(
            f"voxel with {counts.max()} triangles exceeds the packed-layout "
            f"cap; increase grid resolution"
        )

    # occupancy + empty-box field, shaped [z, y, x] like the z-major index
    if leap == "box":
        # grown on the grid's device (kernel G on the card); the words
        # come back once for the rows' assembly
        with part("rt.pack.G"):
            cs = grid.arrays.cell_start
            words = empty_boxes((cs[1:] > cs[:-1]).reshape(nz, ny, nx))
        with part("rt.pack.words_to_host"):
            extw = words.reshape(-1).cpu().numpy().view(np.uint32)
    elif leap == "cheb":
        occ = (counts > 0).reshape(nz, ny, nx)
        d = np.maximum(chebyshev_distance_field(occ) - 1, 0)
        ext = np.broadcast_to(d, (6,) + occ.shape).astype(np.int32)
        extw = pack_extents(ext).reshape(-1)
    else:
        raise ValueError(f"unknown leap mode {leap!r}")

    if inline:
        # cell c's first row IS row c; rows 2..n live contiguously in the
        # overflow region starting at n_cells
        overflow = np.maximum(nblk - 1, 0)
        ov_first = np.full(n_cells, n_cells, np.int64)
        np.cumsum(overflow[:-1], out=ov_first[1:])
        ov_first += n_cells
        total_blocks = max(int(n_cells + overflow.sum()), 1)
        info = np.zeros(1, np.uint32)  # unused by the inline march
    else:
        first = np.zeros(n_cells, np.int64)
        np.cumsum(nblk[:-1], out=first[1:])
        total_blocks = int(first[-1] + nblk[-1]) if n_cells else 0
        total_blocks = max(total_blocks, 1)
        if total_blocks > _FIRST_MASK:
            raise ValueError(f"{total_blocks} blocks exceeds the 21-bit block index")
        info = np.where(
            counts > 0,
            first.astype(np.uint32) | (nblk.astype(np.uint32) << _NBLK_SHIFT),
            _EMPTY_FLAG | extw,
        )

    v = np.asarray(verts, np.float32)[np.asarray(faces)]  # (F, 3, 3)
    tri9 = v.reshape(-1, 9)  # (F, 9) [v0 v1 v2]

    blocks = np.zeros((total_blocks, row_lanes), np.float32)
    slot_tri = np.full((total_blocks * block_tris,), -1, np.int32)

    if inline and n_cells:
        # headers into every cell row's last two lanes (empty cells too)
        hdr = blocks[:n_cells, row_lanes - 2:].view(np.int32)
        hdr[:, 0] = np.where(counts > 0, ov_first, extw.astype(np.int64)).astype(np.int32)
        hdr[:, 1] = nblk.astype(np.int32)

    nnz = tri_ids.shape[0]
    if nnz:
        # CSR entry e of cell c has slot e - cell_start[c] in the cell
        entry_cell = np.repeat(np.arange(n_cells, dtype=np.int64), counts)
        within = np.arange(nnz, dtype=np.int64) - cell_start[entry_cell]
        if inline:
            row = np.where(within < block_tris, entry_cell,
                           ov_first[entry_cell] + within // block_tris - 1)
        else:
            row = first[entry_cell] + within // block_tris
        slot = within % block_tris
        blocks_flat = blocks.reshape(-1)
        lane0 = row * row_lanes + slot * 9
        for c in range(9):
            blocks_flat[lane0 + c] = tri9[tri_ids, c]
        slot_tri[row * block_tris + slot] = tri_ids

    meta = PackedGridMeta(
        n_voxels=(nx, ny, nz),
        n_blocks=total_blocks,
        probe_delta=max(min_w * 1e-3, 1e-6),
        block_tris=block_tris,
        row_lanes=row_lanes,
        max_blocks=int(nblk.max(initial=1)),
        inline=inline,
    )
    if as_numpy:
        arrays = PackedGridArrays(
            lower=np.asarray(host.lower, np.float32), upper=np.asarray(host.upper, np.float32),
            width=np.asarray(host.width, np.float32),
            inv_width=np.asarray(host.inv_width, np.float32),
            cell_info=info.view(np.int32), blocks=blocks, slot_tri=slot_tri)
        return PackedGrid(arrays=arrays, meta=meta)
    dev = grid.arrays.lower.device
    with part("rt.pack.upload"):
        arrays = PackedGridArrays(
            lower=grid.arrays.lower, upper=grid.arrays.upper,
            width=grid.arrays.width, inv_width=grid.arrays.inv_width,
            cell_info=torch.from_numpy(info.view(np.int32).copy()).to(dev),
            blocks=torch.from_numpy(blocks).to(dev),
            slot_tri=torch.from_numpy(slot_tri).to(dev),
        )
    return PackedGrid(arrays=arrays, meta=meta)


def packed_from_numpy(arrays, meta, device=None) -> PackedGrid:
    """Carry a packed grid across: `arrays` has the fields of
    PackedGridArrays as numpy (the JAX package's, pulled to the host;
    cell_info as uint32 or int32 bits), `meta` the fields of
    PackedGridMeta.  Two marches can then run on one grid."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    info = np.ascontiguousarray(np.asarray(arrays.cell_info))
    info = info.view(np.int32) if info.dtype == np.uint32 else info.astype(np.int32)
    out = PackedGridArrays(
        lower=f32(arrays.lower), upper=f32(arrays.upper), width=f32(arrays.width),
        inv_width=f32(arrays.inv_width),
        cell_info=torch.as_tensor(info.copy(), device=dev),
        blocks=f32(arrays.blocks).contiguous(),
        slot_tri=torch.as_tensor(np.array(arrays.slot_tri, np.int32), device=dev),
    )
    m = PackedGridMeta(
        n_voxels=tuple(int(n) for n in meta.n_voxels), n_blocks=int(meta.n_blocks),
        probe_delta=float(meta.probe_delta), block_tris=int(meta.block_tris),
        row_lanes=int(meta.row_lanes), max_blocks=int(meta.max_blocks),
        inline=bool(meta.inline),
    )
    return PackedGrid(arrays=out, meta=m)
