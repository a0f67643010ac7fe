"""The port's fit loop and checkpoints (mirrors tests/test_opt.py and
tests/test_fit_geometry.py for everything without a device mesh).

* The fit reduces the loss; the loss history of 6 Adam steps on kd equals
  the JAX `fit`'s (jitted) to rtol 1e-4, and a vertex fit with grid
  rebuilds every 2 steps (the port rebuilds unpadded, the JAX package
  pads to a static meta) keeps to the JAX history to rtol 1e-4 too (both
  within 4e-7 measured).
* The fit on the packed traversal; the persistent wave's camera refill
  gives the tiled march's loss and gradients.
* Multi-bounce gradients are finite; split/merge round-trips.
* Checkpoints: the round trip (params and Adam's state), the latest
  step, atomic saves, incomplete directories skipped, resume keeping to
  the total step budget, a checkpoint the JAX package saved with its npz
  backend restored into the port (params and optax's Adam state) and the
  port's read by JAX.
* `cli fit` on the gradcheck scene prints the first and last loss.
"""

import builtins
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.opt import checkpoint as jax_ckpt  # noqa: E402
from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import checkpoint, fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


@pytest.fixture(scope="module")
def prep():
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    return prepare(_replace(cfg, ray_tile=64), scene=scene)


def _perturbed(prep, **scale):
    p = fit.split_scene(prep.scene)
    return prep._replace(scene=fit.merge_scene(
        p._replace(**{k: getattr(p, k) * v for k, v in scale.items()}), prep.scene))


def test_fit_reduces_loss(prep):
    target = render(prep)
    p = fit.split_scene(prep.scene)
    perturbed = p._replace(kd=p.kd * 1.8, ka=p.ka * 0.3, base_color=p.base_color * 0.7)
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, optimizer="adam", lr=5e-2,
                                     trainable=("base_color", "kd", "ka"))
    params, opt = init(perturbed)
    losses = []
    for _ in range(15):
        params, opt, loss = step(params, opt, prep.scene, prep.grid.arrays, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses
    assert not params.verts.requires_grad  # frozen fields take no gradient
    np.testing.assert_array_equal(prep.scene.materials.kd.numpy(), p.kd.numpy())


def test_fit_loss_history_matches_jax(prep, tiny_prep):
    """6 Adam steps on kd (lr 5e-2) from kd * 1.6: the port's losses equal
    the JAX fit's to rtol 1e-4 (torch.optim.Adam with optax's defaults)."""
    target = render(prep)
    _, losses = fit.fit(_perturbed(prep, kd=1.6), target, steps=6, lr=5e-2,
                        trainable=("kd",), log_every=0)
    jtarget = jax_renderer.render(tiny_prep)
    jp = jax_fit.split_scene(tiny_prep.scene)
    jprep = tiny_prep._replace(scene=jax_fit.merge_scene(jp._replace(kd=jp.kd * 1.6),
                                                         tiny_prep.scene))
    _, jlosses = jax_fit.fit(jprep, jtarget, steps=6, lr=5e-2, trainable=("kd",), log_every=0)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_fit_on_packed_traversal(prep):
    packed = prepare(_replace(prep.cfg, traversal="packed", faithful=False), scene=prep.scene)
    target = render(packed)
    _, losses = fit.fit(_perturbed(packed, kd=1.6), target, steps=6, lr=5e-2,
                        trainable=("kd",), log_every=0)
    assert losses[-1] < losses[0]


def test_fit_persistent_camera_refill_matches_tiled(prep):
    """The persistent wave makes the popped rays from their pixel index
    (the camera refill): loss and gradients equal the tiled march's, and a
    short fit through it reduces the loss."""
    preps = {s: prepare(_replace(prep.cfg, faithful=False, traversal="packed", scheduler=s,
                                 wave=128), scene=prep.scene) for s in ("tiled", "persistent")}
    target = render(preps["tiled"])
    out = {}
    for s, p in preps.items():
        params = fit.split_scene(p.scene)
        leaves = {f: getattr(params, f).clone().requires_grad_(True)
                  for f in ("verts", "base_color", "kd", "ks", "ka", "light_pos")}
        leaves["kd"] = (params.kd * 1.5).detach().requires_grad_(True)
        loss = fit.image_loss(params._replace(**leaves), p.scene, p.packed.arrays,
                              p.packed.meta, p.cfg, target)
        out[s] = (float(loss.detach()), torch.autograd.grad(loss, list(leaves.values())))
    np.testing.assert_allclose(out["persistent"][0], out["tiled"][0], rtol=1e-5)
    for a, b in zip(out["persistent"][1], out["tiled"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7)
    _, losses = fit.fit(_perturbed(preps["persistent"], kd=1.5), target, steps=6, lr=5e-2,
                        trainable=("kd",), log_every=0)
    assert losses[-1] < losses[0]


def test_vertex_fit_with_rebuilds_matches_jax(prep, tiny_prep):
    """Recover a vertex perturbation with grid rebuilds every 2 steps: the
    loss falls, and its history keeps to the JAX fit's (which pads each
    rebuilt grid to a static meta; the port rebuilds unpadded) to rtol
    1e-4."""
    target = render(prep)
    bump = np.random.default_rng(3).normal(scale=0.03, size=tuple(prep.scene.verts.shape))
    bump = bump.astype(np.float32)
    p = fit.split_scene(prep.scene)
    moved = prepare(prep.cfg, scene=fit.merge_scene(p._replace(verts=p.verts + torch.from_numpy(
        bump)), prep.scene))
    _, losses = fit.fit(moved, target, steps=6, lr=5e-3, trainable=("verts",),
                        rebuild_grid_every=2, log_every=0)
    assert losses[-1] < losses[0], losses
    jp = jax_fit.split_scene(tiny_prep.scene)
    jmoved = jax_renderer.prepare(tiny_prep.cfg, scene=jax_fit.merge_scene(
        jp._replace(verts=jp.verts + jnp.asarray(bump)), tiny_prep.scene))
    _, jlosses = jax_fit.fit(jmoved, jax_renderer.render(tiny_prep), steps=6, lr=5e-3,
                             trainable=("verts",), rebuild_grid_every=2, log_every=0)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_multibounce_gradients_finite(prep):
    """Reflective spheres and 2 bounces: the retired lanes' inf origins
    leak no NaN into the backward."""
    mats = prep.scene.materials._replace(reflective=torch.tensor([False, True]),
                                         km=torch.tensor([0.0, 0.5]))
    p2 = prepare(_replace(prep.cfg, max_bounces=2), scene=prep.scene._replace(materials=mats))
    params = fit.split_scene(p2.scene)
    fields = [f for f in fit.SceneParams._fields if getattr(params, f) is not None]
    leaves = {f: getattr(params, f).clone().requires_grad_(True) for f in fields}
    loss = fit.image_loss(params._replace(**leaves), p2.scene, p2.grid.arrays, p2.grid.meta,
                          p2.cfg, torch.zeros((SIZE, SIZE, 3)))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert any(g is not None and bool(g.abs().max() > 0) for g in grads)
    for f, g in zip(fields, grads):
        assert g is None or bool(torch.isfinite(g).all()), f


def test_merge_split_roundtrip(prep):
    params = fit.split_scene(prep.scene)
    merged = fit.merge_scene(params, prep.scene)
    for a, b in zip(fit.split_scene(merged), params):
        assert (a is None and b is None) or torch.equal(a, b)
    assert merged.faces is prep.scene.faces
    assert params.texture_image is None and params.extra_light_pos is None


def test_train_step_refuses_what_is_not_ported(prep):
    """Unknown fields are refused; mesh= is served
    (tests/test_torch_fit_sharded.py holds it on 2 and 4 ranks): on a
    one-rank group the sharded step's loss and gradients are the
    unsharded step's bits; and so is the ring train step
    (tests/test_torch_ring_fit.py holds it on 2 and 4 ranks): on a
    one-shard ring its loss is the unsharded step's to rtol 1e-6 and its
    gradients to rtol 1e-4."""
    from torch_ranks import one_rank_group

    from ray_tracer_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="unknown trainable"):
        fit.make_train_step(prep.grid.meta, prep.cfg, trainable=("kd", "nope"))
    target = torch.full((16, 16, 3), 10.0)
    with one_rank_group() as mesh:
        out = []
        for m in (None, mesh):
            step, init = fit.make_train_step(prep.grid.meta, prep.cfg, lr=1e-3, mesh=m,
                                             trainable=("kd", "verts"))
            params, opt = init(fit.split_scene(prep.scene))
            params, _, loss = step(params, opt, prep.scene, prep.grid.arrays, target)
            out.append((loss, params.kd.grad, params.verts.grad))
        ring = make_mesh(1, ("tris",), shape=(1,), devices="cpu")
        step, init, ring_scene = fit.make_ring_train_step(prep, ring, rays_axis=None, lr=1e-3,
                                                          trainable=("kd", "verts"))
        params, opt = init(fit.split_scene(prep.scene))
        params, _, loss = step(params, opt, ring_scene, target)
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert float(loss) == pytest.approx(float(out[0][0]), rel=1e-6)
    for g, want in ((params.kd.grad, out[0][1]), (params.verts.grad, out[0][2])):
        scale = float(want.abs().max())
        assert float(((g - want).abs() - 1e-4 * want.abs()).max()) <= 1e-6 * scale


def _trained(prep, steps=2):
    """(params, Adam optimizer) after a few steps on kd and base_color."""
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, lr=1e-2,
                                     trainable=("kd", "base_color"))
    params, opt = init(fit.split_scene(_perturbed(prep, kd=1.3).scene))
    target = render(prep)
    for _ in range(steps):
        params, opt, _ = step(params, opt, prep.scene, prep.grid.arrays, target)
    return params, opt, step, target


def test_checkpoint_roundtrip(prep, tmp_path):
    """Params and Adam's state come back; the restored optimizer's next
    step equals the uninterrupted one's."""
    params, opt, step, target = _trained(prep)
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, params, opt, step_num=3)
    fresh, opt2 = fit.make_train_step(prep.grid.meta, prep.cfg, lr=1e-2,
                                      trainable=("kd", "base_color"))[1](
        fit.split_scene(prep.scene))
    p2, o2 = checkpoint.restore_checkpoint(d, {"params": fresh, "opt_state": opt2}, step_num=3)
    assert o2 is opt2
    for a, b in zip(p2, params):
        assert (a is None and b is None) or torch.equal(a, b.detach())
    with torch.no_grad():
        for a, b in zip(fresh, p2):
            if a is not None:
                a.copy_(b)
    fresh, _, l2 = step(fresh, opt2, prep.scene, prep.grid.arrays, target)
    params, _, l1 = step(params, opt, prep.scene, prep.grid.arrays, target)
    assert float(l1) == float(l2)
    assert torch.equal(fresh.kd, params.kd) and torch.equal(fresh.base_color, params.base_color)


def test_checkpoint_restore_latest_step(prep, tmp_path):
    params = fit.split_scene(prep.scene)
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, params, step_num=5)
    checkpoint.save_checkpoint(d, params._replace(kd=params.kd * 2), step_num=9)
    p2, o2 = checkpoint.restore_checkpoint(d, {"params": params, "opt_state": None})
    assert torch.equal(p2.kd, params.kd * 2) and o2 is None


def test_incomplete_checkpoint_skipped_on_resume(tmp_path):
    params = {"w": torch.arange(4.0)}
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, params, step_num=10)
    os.makedirs(os.path.join(d, "step_20"))  # an interrupted save: no meta.json
    os.makedirs(os.path.join(d, "step_30.tmp"))
    assert checkpoint.latest_step(d) == 10
    got, _ = checkpoint.restore_checkpoint(d, {"params": params},
                                           step_num=checkpoint.latest_step(d))
    assert torch.equal(got["w"], params["w"])
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None


def test_checkpoint_save_is_atomic(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, {"w": torch.zeros(3)}, step_num=1)
    checkpoint.save_checkpoint(d, {"w": torch.ones(3)}, step_num=1)  # the same step again
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    got, _ = checkpoint.restore_checkpoint(d, {"params": {"w": torch.zeros(3)}}, step_num=1)
    assert torch.equal(got["w"], torch.ones(3))
    with pytest.raises(ValueError, match="without opt_state"):
        checkpoint.restore_checkpoint(d, {"params": {"w": torch.zeros(3)},
                                          "opt_state": torch.optim.SGD([torch.zeros(1)], 0.1)})


def test_fit_resume_respects_total_step_budget(prep, tmp_path):
    target = render(prep)
    d = str(tmp_path / "ck")
    kw = dict(lr=1e-3, checkpoint_dir=d, checkpoint_every=1, log_every=0,
              trainable=("base_color",))
    _, l1 = fit.fit(prep, target, steps=2, **kw)
    assert len(l1) == 2
    _, l2 = fit.fit(prep, target, steps=3, resume=True, **kw)
    assert len(l2) == 1  # only step 2 of the 3-step budget remains
    assert os.path.isdir(os.path.join(d, "step_3"))


def test_jax_npz_checkpoint_params_restore(prep, tiny_prep, tmp_path, monkeypatch):
    """A checkpoint the JAX package saved with its npz backend (orbax made
    unimportable) gives the port its params, in SceneParams field order,
    and its optax state (Adam's, fresh: step 0, zero moments) loads into
    the port's Adam.  The JAX package reads the port's params back."""
    real_import = builtins.__import__

    def no_orbax(name, *a, **k):
        if name.startswith("orbax"):
            raise ImportError("forced npz backend")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_orbax)
    monkeypatch.delitem(sys.modules, "orbax.checkpoint", raising=False)
    jp = jax_fit.split_scene(tiny_prep.scene)
    jp = jp._replace(kd=jp.kd * 1.25, verts=jp.verts + 0.5)
    _, init = jax_fit.make_train_step(tiny_prep.grid.meta, tiny_prep.cfg)
    d = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(d, jp, init(jp), step_num=4)
    with open(os.path.join(d, "step_4", "meta.json")) as fh:
        assert json.load(fh)["backend"] == "npz"
    step, init_t = fit.make_train_step(prep.grid.meta, prep.cfg, trainable=("kd", "verts"))
    params, opt = init_t(fit.split_scene(prep.scene))
    p2, o2 = checkpoint.restore_checkpoint(d, {"params": params, "opt_state": opt})
    assert o2 is opt
    for p in (params.kd, params.verts):
        st = opt.state[p]
        assert float(st["step"]) == 0.0 and st["exp_avg"].shape == p.shape
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    for f in fit.SceneParams._fields:
        a, b = getattr(p2, f), getattr(jp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    d2 = str(tmp_path / "port")
    checkpoint.save_checkpoint(d2, p2, step_num=1)
    back, _ = jax_ckpt.restore_checkpoint(d2, {"params": jax_fit.split_scene(tiny_prep.scene),
                                               "opt_state": None}, step_num=1)
    np.testing.assert_array_equal(np.asarray(back.kd), np.asarray(jp.kd))


def test_cli_fit_on_gradcheck(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "fit", "--scene", "gradcheck",
         "--width", "16", "--steps", "4", "--device", "cpu", "--out-dir", str(tmp_path / "ck")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"first_loss", "last_loss"}
    assert res["last_loss"] < res["first_loss"]
    assert "step 0 loss" in out.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "fit", "--width", "8", "--steps", "1",
         "--device", "cpu", "--config", "scene.json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    # --config is served now: a missing file is an error, not a refusal
    assert bad.returncode != 0 and "FileNotFoundError" in bad.stderr
