"""The whole slice on the CPU: the port's render against the C++ oracle
and the JAX package's render.

With float64 determinants the serial scene (one shadow ray per hit) and
the parallel scene (material table, 3 mirror bounces) are byte-identical
to `native/build/oracle`, as tests/test_render_golden.py pins the JAX
package; the all-pairs configuration follows tests/test_pallas.py's rule.
"""

import dataclasses
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.io.ppm import read_ppm  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.io.ppm import tonemap_u8, write_ppm  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.models.scenes import asset  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 32


def _f64(cfg, **kw):
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, det_dtype="float64", **kw))


def _ppm_bytes(img, path):
    write_ppm(str(path), img.numpy())
    return read_ppm(str(path))


def test_serial_scene_byte_identical_to_oracle_and_jax(oracle_bin, tmp_path):
    out = str(tmp_path / "oracle.ppm")
    subprocess.run(
        [oracle_bin, "--width", str(SIZE), "--height", str(SIZE), "--out", out,
         "--mesh", asset("spot_triangulated.obj"),
         "--mesh", asset("blub_triangulated.obj") + ":1.5,0,0"],
        check=True, capture_output=True, timeout=300,
    )
    got = _ppm_bytes(render(prepare(_f64(scenes.serial_scene_config(SIZE, SIZE)),
                                    device="cpu")), tmp_path / "port.ppm")
    want = read_ppm(out)
    assert (got == want).all(), f"{(got != want).sum()} byte mismatches vs oracle"
    jimg = np.asarray(jax_renderer.render(jax_renderer.prepare(
        _f64(jax_scenes.serial_scene_config(SIZE, SIZE)))))
    assert (tonemap_u8(jimg) == got).all()


def test_parallel_scene_byte_identical_to_oracle(oracle_bin, tmp_path):
    """The arguments of tests/test_render_golden.py's parallel case."""
    out = str(tmp_path / "par.ppm")
    subprocess.run(
        [oracle_bin, "--variant", "parallel",
         "--width", str(SIZE), "--height", str(SIZE), "--out", out,
         "--camera", "18,18,19", "--fov", "60", "--light", "2,5,0",
         "--mesh", asset("plane.obj") + ":0,0.4,0:3:0",
         "--mesh", asset("blub_triangulated.obj") + ":-2,0,0:5:1",
         "--mesh", asset("spot_triangulated.obj") + ":0,0,0:5:1",
         "--mesh", asset("blub_triangulated.obj") + ":2,0,0:5:3"],
        check=True, capture_output=True, timeout=300,
    )
    cfg = _f64(scenes.parallel_scene_config(SIZE, SIZE), ray_tile=1024)
    got = _ppm_bytes(render(prepare(cfg, device="cpu")), tmp_path / "port_par.ppm")
    want = read_ppm(out)
    assert (got == want).all(), f"{(got != want).sum()} byte mismatches vs oracle"


def test_brute_pallas_render_matches_jax():
    """traversal="brute_pallas" on the gradcheck scene at 16x16: at most
    1% of pixels differ by more than 2 counts from the JAX render (the
    JAX side's jitted f32 shading rounds differently)."""
    jscene, jcfg = jax_scenes.gradcheck_scene(16, 16)
    tscene, tcfg = scenes.gradcheck_scene(16, 16, device="cpu")

    def pallas(cfg):
        return dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, traversal="brute_pallas", faithful=False, ray_tile=256))

    want = tonemap_u8(np.asarray(jax_renderer.render(
        jax_renderer.prepare(pallas(jcfg), scene=jscene))))
    got = tonemap_u8(render(prepare(pallas(tcfg), scene=tscene)).numpy())
    diff = np.abs(want.astype(int) - got.astype(int)).max(axis=-1)
    assert (diff > 2).mean() < 0.01
    assert got.any()


@pytest.mark.parametrize("traversal", ["csr", "brute_pallas", "brute"])
def test_image_does_not_depend_on_ray_tile(traversal):
    """The CPU path chunks rays by ray_tile; the image is bitwise the
    same for any chunk size, as one whole-batch trace on the card."""
    scene, cfg = scenes.gradcheck_scene(16, 16, device="cpu")
    imgs = []
    for tile in (37, 256):
        c = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, traversal=traversal, ray_tile=tile))
        imgs.append(render(prepare(c, scene=scene)))
    assert torch.equal(imgs[0], imgs[1])
