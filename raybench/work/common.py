"""What the upstream's algorithm needs for a frame's rays, counted in
the benchmark's own plain code (`raybench/reference/grid.walk`): the
cells each ray's uniform-grid walk visits and the triangles it tests
there with Cramer's rule.  The counts depend only on the scene, the
camera and the traffic, never on what a kernel of the program does.

Operations: a test is `CRAMER_TEST_OPS` (the columns, four determinants,
three divisions and the acceptance test); a visited cell is
`CELL_VISIT_OPS` (its index, 4; the next-crossing comparison, 3; the step
along the axis, its bound check, the crossing's advance and the exit
test, 4; the cell's range, 1).  Bytes: each input byte read once (the
rays, the triangles' 36 bytes, the grid's start table and entries) and
each output byte written once."""

from __future__ import annotations

import torch

from raybench.reference.geometry import CRAMER_TEST_OPS, make_scene
from raybench.reference.grid import build_grid

CELL_VISIT_OPS = 4 + 3 + 4 + 1
CHUNK = 1 << 21  # pixels a pass


def scene_and_grid(config: dict, device):
    """The reference scene and the upstream's grid (rm 3, max 64, each
    triangle in every cell its box touches)."""
    scene = make_scene(config, device, torch.float32)
    return scene, build_grid(scene.v0, scene.v1, scene.v2, 3.0, 64, device=device)


def ops_of(tested: int, visits: int) -> int:
    return tested * CRAMER_TEST_OPS + visits * CELL_VISIT_OPS


def input_bytes(scene, grid) -> int:
    return 36 * scene.v0.shape[0] + 8 * (grid.cells + 1) + 4 * grid.entries


def pixel_passes(size: int, device):
    for s in range(0, size * size, CHUNK):
        yield torch.arange(s, min(size * size, s + CHUNK), device=device)
