"""Each work counter against a hand count on a one-triangle scene: the
triangle (0,0,0), (1,0,0), (0,1,0) in the z = 0 plane makes a flat box
cut 4 x 4 x 1 (n_k = int(3 delta_k / delta_max + 1)), every cell holding
the triangle; a 2 x 2 camera straight above (0.25, 0.25) sends four rays
down into cell (0,0) or (1,1) regions, each visiting one cell and testing
one triangle to its hit.  Every secondary ray (a shadow ray, a bounce)
leaves the plane upward from its mint, outside the flat box: no walk."""

import json

import pytest

from raybench.reference.geometry import CRAMER_TEST_OPS
from raybench.work import C, E, F
from raybench.work.common import CELL_VISIT_OPS


@pytest.fixture
def config(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")

    def make(variant):
        return {
            "meshes": [{"obj": str(obj), "material": 0, "offset": [0, 0, 0], "scale": 1.0}],
            "materials": [{"base_color": [255.0, 0, 0], "kd": 1.0, "ks": 1.0, "spec_alpha": 2.0,
                           "ka": 0.1, "km": 0.0, "reflective": False}],
            "camera": {"position": [0.25, 0.25, 5.0], "target": [0.25, 0.25, 0.0],
                       "up": [0.0, 1.0, 0.0], "fov_degrees": 10.0},
            "light": {"position": [0.25, 0.25, 3.0], "intensity": 10.0},
            "shading": {"variant": variant, "max_bounces": 3, "shadow_eps": 0.1,
                        "shadow_scale": 0.5, "background": [0.0, 0.0, 0.0]},
        }
    return make


# the grid: 4 x 4 x 1 cells, one entry each; the box read once
GRID_BYTES = 36 * 1 + 8 * (16 + 1) + 4 * 16
HAND = {"tested": 4, "visits": 4, "ops": 4 * CRAMER_TEST_OPS + 4 * CELL_VISIT_OPS, "rays": 4}


@pytest.mark.parametrize("kernel, variant, extra, out_bytes", [
    (C, "serial", {}, 24 + 8 + 1),
    (E, "parallel", {}, 12),
    (F, "serial", {"gi_samples": 4, "gi_depth": 2}, 12),
], ids=["C", "E", "F"])
def test_counter_equals_hand_count(config, kernel, variant, extra, out_bytes):
    traffic = {"size": 2, "render": extra}
    got = kernel.count(config(variant), traffic, "cpu")
    assert {k: got[k] for k in HAND} == HAND
    assert got["bytes"] == GRID_BYTES + 4 * out_bytes


def test_counts_are_frozen_data():
    from raybench.harness import cells
    for w in cells.benchmark()["workloads"]:
        counts = cells.work_counts(w["name"])
        assert json.loads(json.dumps(counts)) == counts
