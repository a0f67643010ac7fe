"""The system under test: `ray_tracer_tpu_torch`, driven the way a user
drives it.  Frames are `render.renderer.render(prepare(cfg))`; the fit is
the step of `opt.fit.make_train_step` (Adam, the grid held fixed as `fit`
holds it between rebuilds).  Every knob comes from the traffic file, so
no tuned table or probe of the program can move a cell.

The port is imported here, inside functions, and only after the run has
found its card."""

from __future__ import annotations

import time

import torch


def perturbation(traffic: dict, n_verts: int, n_mats: int, seed: int, device) -> dict:
    """The fit's start, drawn from the seed on the device in a few calls:
    a vertex offset (V,3), relative factors of the trained materials'
    columns and an offset of the light.  Both sides take these same
    tensors."""
    p = traffic["perturb"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device, generator=g)

    def factor(shape):
        return 1.0 + p["material_rel"] * (2.0 * torch.rand(shape, **f32) - 1.0)

    return {
        "verts": p["verts_sigma"] * torch.randn((n_verts, 3), **f32),
        "base_color": factor((n_mats, 3)), "kd": factor((n_mats,)),
        "ks": factor((n_mats,)), "ka": factor((n_mats,)),
        "light_pos": p["light_sigma"] * torch.randn((3,), **f32),
    }


def perturbed(values: dict, delta: dict) -> dict:
    """The start's values: offsets added to verts and light_pos, factors
    applied to the material columns."""
    out = {}
    for k, v in values.items():
        out[k] = v + delta[k] if k in ("verts", "light_pos") else v * delta[k]
    return out


def scene_config(config: dict, traffic: dict, size: int):
    """The port's SceneConfig of a configuration under a traffic mix."""
    from ray_tracer_tpu_torch.config import (CameraConfig, GridConfig, LightConfig,
                                             MaterialConfig, MeshConfig, RenderConfig,
                                             SceneConfig)
    from ray_tracer_tpu_torch.models.scenes import asset

    meshes = tuple(MeshConfig(path=asset(m["obj"].split("/")[-1]), material_index=m["material"],
                              offset=tuple(m["offset"]), scale=m["scale"])
                   for m in config["meshes"])
    mats = tuple(MaterialConfig(**m) for m in config["materials"])
    cam = config["camera"]
    sh = config["shading"]
    render = RenderConfig(shading=sh["variant"], max_bounces=sh["max_bounces"],
                          shadow_eps=sh["shadow_eps"], shadow_scale=sh["shadow_scale"],
                          background=tuple(sh["background"]), **traffic["render"],
                          grid=GridConfig(**traffic["grid"]))
    return SceneConfig(
        meshes=meshes, materials=mats,
        camera=CameraConfig(position=tuple(cam["position"]), target=tuple(cam["target"]),
                            up=tuple(cam["up"]), fov_degrees=cam["fov_degrees"],
                            width=size, height=size),
        light=LightConfig(position=tuple(config["light"]["position"]),
                          intensity=config["light"]["intensity"]),
        render=render)


def _norm(x: torch.Tensor) -> float:
    """The 2-norm in float64 (plain arithmetic: no linear-algebra library
    is loaded for it)."""
    x = x.double()
    return float(torch.sqrt(torch.sum(x * x)))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Frames:
    """Closed-loop frames: `call()` renders the prepared scene and returns
    its image once it is complete on the device."""

    def __init__(self, config: dict, traffic: dict, size: int, device, split: dict):
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        self._render = render
        self.device = device
        cfg = scene_config(config, traffic, size)
        t0 = time.perf_counter()
        self.prep = prepare(cfg, device=device)
        sync(device)
        split["prepare_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(int(traffic["warmup_calls"])):
            self.call()
        split["warmup_s"] = time.perf_counter() - t0
        self.image = None

    def call(self):
        self.image = self._render(self.prep)
        sync(self.device)
        return self.image

    def answer(self):
        """The last frame, (H*W, 3) on the device."""
        return self.image.reshape(-1, 3)

    def free(self):
        self.prep = self.image = None


class Fit:
    """Closed-loop train steps of one training object.  Set-up builds the
    target (a render of the configuration's scene), perturbs the scene
    from the seed, prepares its grid, makes the step and drives it through
    `check_steps` steps, keeping what the comparison reads: each step's
    loss, the first gradient as Adam holds it after one step, and the
    parameters after the last; the window goes on with the same object."""

    def __init__(self, config: dict, traffic: dict, size: int, device, split: dict, seed: int):
        from ray_tracer_tpu_torch.opt.fit import make_train_step, split_scene
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        self.device = device
        cfg = scene_config(config, traffic, size)
        t0 = time.perf_counter()
        prep0 = prepare(cfg, device=device)
        target = render(prep0)
        sc = prep0.scene
        m = sc.materials
        values = {"verts": sc.verts, "base_color": m.base_color, "kd": m.kd, "ks": m.ks,
                  "ka": m.ka, "light_pos": sc.light_pos}
        delta = perturbation(traffic, sc.verts.shape[0], m.kd.shape[0], seed, sc.verts.device)
        start = perturbed(values, delta)
        scene = sc._replace(verts=start["verts"], light_pos=start["light_pos"],
                            materials=m._replace(base_color=start["base_color"], kd=start["kd"],
                                                 ks=start["ks"], ka=start["ka"]))
        del prep0
        sync(device)
        split["target_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.prep = prepare(cfg, scene=scene)
        sync(device)
        split["prepare_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fields = tuple(traffic["trainable"])
        step, init = make_train_step(self.prep.packed.meta, cfg, lr=traffic["lr"],
                                     trainable=fields)
        params, opt = init(split_scene(self.prep.scene))
        # torch.optim's first optimizer loads torch._dynamo and its imports
        split["optimizer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p0 = {f: getattr(params, f).detach().clone() for f in fields}
        consts = self.prep.frame().consts
        self.target = target
        self.state = [params, opt]

        def call():
            self.state[0], self.state[1], loss = step(
                self.state[0], self.state[1], self.prep.scene, self.prep.packed.arrays,
                self.target, consts=consts)
            return loss

        self.call_ = call
        self.losses = []
        split["check_steps_s"] = []
        for k in range(int(traffic["check_steps"])):
            t1 = time.perf_counter()
            self.losses.append(float(self.call()))
            split["check_steps_s"].append(time.perf_counter() - t1)
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) g
                self.first_grad = {f: _norm(opt.state.get(getattr(params, f), {}).get(
                    "exp_avg", torch.zeros(())) / 0.1) for f in fields}
        self.change = {f: _norm(getattr(self.state[0], f).detach() - p0[f]) for f in fields}
        split["warmup_s"] = time.perf_counter() - t0
        self.failed = 0

    def call(self):
        loss = self.call_()
        value = float(loss)  # the step's loss on the host: the step is complete
        if value != value or value in (float("inf"), float("-inf")):
            self.failed += 1
        return value

    def free(self):
        self.prep = self.target = self.state = self.call_ = None

