"""The JAX package's default checkpoints (orbax, OCDBT) read by the port
(opt/checkpoint.py's orbax branch, through tensorstore), on the CPU.

* The params of a JAX `save_checkpoint` (with and without its optax
  state) restore bitwise into the port's SceneParams, on the template's
  dtype; the fields the JAX params left None stay None, a field the JAX
  params held (a texture image) comes back; optax's Adam state loads
  into the port's Adam (None where the checkpoint holds no optimizer
  state, as in the JAX package).
* `cli fit --resume --out-dir` on the port goes on from the JAX fit's
  newest step: its first loss is the JAX fit's loss at that step.
* With tensorstore unimportable the restore raises an ImportError that
  names it; the restore imports neither jax nor orbax.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.opt import checkpoint as jax_ckpt  # noqa: E402
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch import cli  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import checkpoint, fit  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16


def _jax_params(tiny_prep):
    """JAX SceneParams with moved values and a texture image; the extra
    lights and the environment map stay None."""
    jp = jax_fit.split_scene(tiny_prep.scene)
    tex = np.random.default_rng(3).random((4, 5, 3)).astype(np.float32)
    return jp._replace(kd=jp.kd * 1.25, verts=jp.verts + 0.5, texture_image=jnp.asarray(tex))


def _port_template(dtype=torch.float32):
    scene, _ = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    p = fit.split_scene(scene)
    p = p._replace(texture_image=torch.zeros((4, 5, 3)))
    return p._replace(**{k: v.to(dtype) for k, v in p._asdict().items() if v is not None})


@pytest.mark.parametrize("with_opt", [False, True], ids=["params", "params_and_optax"])
def test_jax_orbax_params_restore_bitwise(tiny_prep, tmp_path, with_opt):
    jp = _jax_params(tiny_prep)
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, jp, optax.adam(1e-2).init(jp) if with_opt else None,
                             step_num=7)
    with open(os.path.join(d, "step_7", "meta.json")) as fh:
        assert json.load(fh)["backend"] == "orbax"
    like = _port_template()
    opt = torch.optim.Adam([like.kd.requires_grad_()])
    got, o = checkpoint.restore_checkpoint(d, {"params": like, "opt_state": opt})
    assert o is (opt if with_opt else None)
    if with_opt:
        st = opt.state[like.kd]
        assert float(st["step"]) == 0.0 and st["exp_avg"].shape == like.kd.shape
    for f in fit.SceneParams._fields:
        a, b = getattr(got, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.float32 and a.shape == tuple(np.shape(b)), f
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32), err_msg=f)


def test_orbax_params_take_the_template_dtype(tiny_prep, tmp_path):
    jp = _jax_params(tiny_prep)
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, jp, step_num=1)
    got, _ = checkpoint.restore_checkpoint(d, {"params": _port_template(torch.float64)})
    assert got.verts.dtype == torch.float64
    np.testing.assert_array_equal(got.verts.numpy(), np.asarray(jp.verts, np.float64))


def test_cli_fit_resumes_a_jax_run(tiny_prep, tmp_path, capsys):
    """The JAX fit of the command's self-demo (kd x 1.5, base_color x 0.6,
    the default trainable fields, lr 2e-2) checkpoints steps 2 and 4 with
    orbax; the port's `fit --resume` goes on from step 4."""
    d = str(tmp_path / "ck")
    target = jax_renderer.render(tiny_prep)
    jp = jax_fit.split_scene(tiny_prep.scene)
    jprep = tiny_prep._replace(scene=jax_fit.merge_scene(
        jp._replace(kd=jp.kd * 1.5, base_color=jp.base_color * 0.6), tiny_prep.scene))
    trainable = ("base_color", "kd", "ks", "ka", "light_pos")
    _, jlosses = jax_fit.fit(jprep, target, steps=5, lr=2e-2, trainable=trainable,
                             checkpoint_dir=d, checkpoint_every=2, log_every=0)
    assert checkpoint.latest_step(d) == 4
    cli.main(["fit", "--scene", "gradcheck", "--width", str(SIZE), "--steps", "6", "--resume",
              "--out-dir", d, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["first_loss"], jlosses[4], rtol=1e-4)
    assert out["first_loss"] < jlosses[0]
    cli.main(["fit", "--scene", "gradcheck", "--width", str(SIZE), "--steps", "4", "--resume",
              "--out-dir", d, "--device", "cpu"])  # the budget was spent
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "first_loss": None, "last_loss": None}


def _save(tiny_prep, tmp_path):
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, _jax_params(tiny_prep), step_num=2)
    return d


def test_missing_tensorstore_is_named(tiny_prep, tmp_path, monkeypatch):
    d = _save(tiny_prep, tmp_path)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint.restore_checkpoint(d, {"params": _port_template()})


_RESTORE = r"""
import sys
sys.modules["jax"] = None
sys.modules["orbax"] = None
import numpy as np, torch
from ray_tracer_tpu_torch.models import scenes
from ray_tracer_tpu_torch.opt import checkpoint, fit
scene, _ = scenes.gradcheck_scene(16, 16, device="cpu")
like = fit.split_scene(scene)._replace(texture_image=torch.zeros((4, 5, 3)))
got, _ = checkpoint.restore_checkpoint(sys.argv[1], {"params": like})
np.save(sys.argv[2], got.verts.numpy())
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "jaxlib", "orbax", "ray_tracer_tpu")]
assert not loaded, loaded
"""


def test_restore_imports_neither_jax_nor_orbax(tiny_prep, tmp_path):
    d = _save(tiny_prep, tmp_path)
    out_npy = str(tmp_path / "verts.npy")
    out = subprocess.run([sys.executable, "-c", _RESTORE, d, out_npy], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_array_equal(np.load(out_npy), np.asarray(_jax_params(tiny_prep).verts))


def test_template_field_missing_from_the_checkpoint(tiny_prep, tmp_path):
    d = _save(tiny_prep, tmp_path)
    like = _port_template()._replace(env_image=torch.zeros((2, 4, 3)))
    with pytest.raises(ValueError, match="env_image"):
        checkpoint.restore_checkpoint(d, {"params": like})


def test_orbax_fields_come_from_the_metadata(tiny_prep, tmp_path):
    """The fields come from orbax's _METADATA (tree_metadata under
    "params"): the None fields are recorded there and skipped."""
    d = _save(tiny_prep, tmp_path)
    leaves, tops = checkpoint._orbax_leaves(os.path.join(d, "step_2"))
    want = {k for k, v in _jax_params(tiny_prep)._asdict().items() if v is not None}
    assert {k[1] for k in leaves if k[0] == "params"} == want and tops == {"params"}
