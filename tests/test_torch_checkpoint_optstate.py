"""The optimizer's state crosses the two packages' checkpoints, both ways
(opt/checkpoint.py's optax layout), on the CPU: the gradcheck scene at
16x16, kd x 1.6 and light_pos moved, kd and light_pos trained (the other
fields carry zero moments), lr 5e-2.

* Port to JAX: the port's fit takes 2 steps and saves; the JAX package's
  fit(resume=True) goes on to 4, and its params equal the port's
  uninterrupted 4 steps to rtol 1e-4 (test_torch_fit.py's tolerance for
  the two fits).  The o_i arrays follow a flatten of optax's own state.
* JAX to port: the JAX fit takes 4 steps and saves, with its npz backend
  (orbax unimportable) and with orbax; the port's fit(resume=True) goes on
  to 6 and equals the JAX package's uninterrupted 6 steps to rtol 1e-4,
  which a resume with a fresh Adam does not.
* A checkpoint in the port's earlier layout (each tensor's torch state
  entries, listed in meta.json) still restores; SGD checkpoints cross
  both ways (a JAX npz SGD checkpoint is refused by both packages alike:
  optax's SGD state has no leaves, so it holds no o_0).
"""

import builtins
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.opt import fit as jax_fit  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu_torch.models import scenes  # noqa: E402
from ray_tracer_tpu_torch.opt import checkpoint, fit  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare, render  # noqa: E402

SIZE = 16
LR = 5e-2
TRAINABLE = ("kd", "light_pos")
SHIFT = (0.5, -0.3, 0.2)  # added to light_pos
RTOL = 1e-4


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))


@pytest.fixture(scope="module")
def port():
    """(perturbed port prep, target)."""
    scene, cfg = scenes.gradcheck_scene(SIZE, SIZE, device="cpu")
    prep = prepare(_replace(cfg, ray_tile=64), scene=scene)
    target = render(prep)
    p = fit.split_scene(prep.scene)
    p = p._replace(kd=p.kd * 1.6, light_pos=p.light_pos + torch.tensor(SHIFT))
    return prep._replace(scene=fit.merge_scene(p, prep.scene)), target


@pytest.fixture(scope="module")
def jax_side(tiny_prep):
    """(perturbed JAX prep, target)."""
    target = jax_renderer.render(tiny_prep)
    p = jax_fit.split_scene(tiny_prep.scene)
    p = p._replace(kd=p.kd * 1.6, light_pos=p.light_pos + jnp.asarray(SHIFT, p.light_pos.dtype))
    return tiny_prep._replace(scene=jax_fit.merge_scene(p, tiny_prep.scene)), target


@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX package's npz backend: orbax made unimportable."""
    real_import = builtins.__import__

    def refuse(name, *a, **k):
        if name.startswith("orbax"):
            raise ImportError("forced npz backend")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", refuse)
    monkeypatch.delitem(sys.modules, "orbax.checkpoint", raising=False)


def _port_fit(port, steps, optimizer="adam", **kw):
    prep, target = port
    params, _ = fit.fit(prep, target, steps=steps, lr=LR, optimizer=optimizer,
                        trainable=TRAINABLE, log_every=0, **kw)
    return params


def _jax_fit(jax_side, steps, optimizer="adam", **kw):
    prep, target = jax_side
    params, _ = jax_fit.fit(prep, target, steps=steps, lr=LR, optimizer=optimizer,
                            trainable=TRAINABLE, log_every=0, **kw)
    return params


def _close(got, want, what):
    for f in TRAINABLE:
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=RTOL, err_msg=f"{what}: {f}")


def _moved(a, b) -> bool:
    """a and b differ beyond the tolerance in some trained field."""
    return any(not np.allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), rtol=RTOL)
               for f in TRAINABLE)


def test_port_adam_checkpoint_resumes_in_jax(port, jax_side, tmp_path):
    d = str(tmp_path / "ck")
    _port_fit(port, 2, checkpoint_dir=d, checkpoint_every=2)
    resumed = _jax_fit(jax_side, 4, checkpoint_dir=d, checkpoint_every=0, resume=True)
    _close(resumed, _port_fit(port, 4), "JAX resumed from the port's step 2")
    with open(os.path.join(d, "step_2", "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["backend"] == "npz" and meta["optimizer"] == {"class": "Adam", "layout": "optax"}
    # the o_i arrays are optax's leaves: shapes and dtypes of a flatten of its state
    want = jax.tree.leaves(optax.adam(LR).init(jax_fit.split_scene(jax_side[0].scene)))
    data = np.load(os.path.join(d, "step_2", "state.npz"))
    got = [data[f"o_{i}"] for i in range(sum(k.startswith("o_") for k in data.files))]
    assert [(a.shape, a.dtype) for a in got] == [(np.shape(b), np.asarray(b).dtype) for b in want]
    assert int(got[0]) == 2
    fields = [k for k, v in fit.split_scene(port[0].scene)._asdict().items() if v is not None]
    for i, f in enumerate(fields):  # untrained fields: zero moments
        if f not in TRAINABLE:
            assert not got[1 + i].any() and not got[1 + len(fields) + i].any(), f


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_jax_adam_checkpoint_resumes_in_port(port, jax_side, tmp_path, request, backend):
    if backend == "npz":
        request.getfixturevalue("no_orbax")
    d = str(tmp_path / "ck")
    _jax_fit(jax_side, 4, checkpoint_dir=d, checkpoint_every=4)
    with open(os.path.join(d, "step_4", "meta.json")) as fh:
        assert json.load(fh)["backend"] == backend
    uninterrupted = _jax_fit(jax_side, 6)
    resumed = _port_fit(port, 6, checkpoint_dir=d, checkpoint_every=0, resume=True)
    _close(resumed, uninterrupted, f"the port resumed from JAX's {backend} step 4")

    # a fresh Adam from the same params does not keep to the JAX run
    prep, target = port
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, lr=LR, trainable=TRAINABLE)
    params, opt = init(fit.split_scene(prep.scene))
    restored, _ = checkpoint.restore_checkpoint(d, {"params": params}, step_num=4)
    params, opt = init(restored)
    for _ in range(2):
        params, opt, _ = step(params, opt, prep.scene, prep.grid.arrays, target)
    assert _moved(fit.detached(params), uninterrupted)


def _earlier_layout(d, params, opt, step_num):
    """A checkpoint as the port wrote it before optax's layout: each
    tensor's torch state entries as o_i, their (index, key) list in
    meta.json."""
    state = opt.state_dict()["state"]
    keys = [[i, k] for i in sorted(state) for k in state[i]]
    arrays = {f"p_{i}": x.detach().numpy() for i, x in enumerate(checkpoint._leaves(params))}
    arrays.update({f"o_{j}": np.asarray(state[i][k]) for j, (i, k) in enumerate(keys)})
    path = os.path.join(d, f"step_{step_num}")
    os.makedirs(path)
    np.savez(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"backend": "npz", "step": step_num,
                   "optimizer": {"class": type(opt).__name__, "keys": keys}}, fh)


def test_earlier_port_layout_restores(port, tmp_path):
    """A checkpoint in the port's earlier layout restores Adam's state
    bitwise."""
    prep, target = port
    step, init = fit.make_train_step(prep.grid.meta, prep.cfg, lr=LR, trainable=TRAINABLE)
    params, opt = init(fit.split_scene(prep.scene))
    for _ in range(2):
        params, opt, _ = step(params, opt, prep.scene, prep.grid.arrays, target)
    d = str(tmp_path / "ck")
    _earlier_layout(d, params, opt, 2)
    fresh, opt2 = init(fit.split_scene(prep.scene))
    _, o2 = checkpoint.restore_checkpoint(d, {"params": fresh, "opt_state": opt2})
    assert o2 is opt2
    for q in TRAINABLE:
        a, b = opt.state[getattr(params, q)], opt2.state[getattr(fresh, q)]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k]), (q, k)


def test_sgd_checkpoints_cross_both_ways(port, jax_side, tmp_path, no_orbax, monkeypatch):
    # port -> JAX (npz): optax's SGD state has no leaves; o_0 is the marker
    # the JAX reader asks for
    d = str(tmp_path / "port")
    _port_fit(port, 2, optimizer="sgd", checkpoint_dir=d, checkpoint_every=2)
    data = np.load(os.path.join(d, "step_2", "state.npz"))
    assert sorted(k for k in data.files if k.startswith("o_")) == ["o_0"]
    assert jax.tree.leaves(optax.sgd(LR).init(jax_fit.split_scene(jax_side[0].scene))) == []
    resumed = _jax_fit(jax_side, 4, optimizer="sgd", checkpoint_dir=d, checkpoint_every=0,
                       resume=True)
    _close(resumed, _port_fit(port, 4, optimizer="sgd"), "JAX SGD resumed from the port's")
    # a JAX npz SGD checkpoint holds no o_i: both packages refuse it alike
    dj = str(tmp_path / "jax_npz")
    _jax_fit(jax_side, 2, optimizer="sgd", checkpoint_dir=dj, checkpoint_every=2)
    with pytest.raises(ValueError, match="without opt_state"):
        _jax_fit(jax_side, 4, optimizer="sgd", checkpoint_dir=dj, checkpoint_every=0,
                 resume=True)
    with pytest.raises(ValueError, match="without opt_state"):
        _port_fit(port, 4, optimizer="sgd", checkpoint_dir=dj, checkpoint_every=0, resume=True)
    # JAX -> port (orbax, the JAX package's default backend)
    monkeypatch.undo()
    do = str(tmp_path / "jax_orbax")
    _jax_fit(jax_side, 4, optimizer="sgd", checkpoint_dir=do, checkpoint_every=4)
    with open(os.path.join(do, "step_4", "meta.json")) as fh:
        assert json.load(fh)["backend"] == "orbax"
    resumed = _port_fit(port, 6, optimizer="sgd", checkpoint_dir=do, checkpoint_every=0,
                        resume=True)
    _close(resumed, _jax_fit(jax_side, 6, optimizer="sgd"), "the port's SGD resumed from JAX's")
