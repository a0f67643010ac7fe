"""The ring's hops, its shading epilogue and the path tracer's ring
interface against the JAX package op by op (`jax.disable_jit()`), in one
process: JAX's `_ring_local_best`, `_grid_local_best`, `_ring_shade` and
`pathtrace_rays(tracer=)` take plain callables, so they run outside
shard_map.  The same numpy inputs (the gradcheck scene at 16x16, its
camera rays) go to both packages.

* The all-pairs hop (`_ring_local_best`: t, global id, material, vertices,
  any-pass and the corner payload) bitwise, float32 and float64
  determinants, with and without a t_lower, rays bounded by maxt.
* The grid hop (`_grid_local_best`) bitwise on shard 1 of the 2-shard ring
  grids (nearest and any hit): the march is kernel C's plain version here.
* `_ring_shade` bitwise under the same orbit (two shards emulated by the
  hops and the orbit's merge, written for each package alike): mirror
  bounces, serial shading, smooth normals, a checker texture, an extra
  light and an area light; soft visibility and soft primary to rtol 1e-5
  (the sigmoid's exp: torch's and XLA's differ in the last bits on a few
  inputs).
* Gradients through `_ring_shade` (verts, base_color, km, light_pos)
  against eager jax.grad, rtol 1e-4 with atol 1e-6 max|g|.
* `pathtrace_rays(tracer=)` with the same fake tracer: bitwise at gi_depth
  0 (the next-event estimate and escapes, with smooth normals and a
  texture from the carried payload), by the GI tests' statistical rule at
  depth 1 under an environment map; a tracer without corner normals is
  refused with smooth normals, as in the JAX package.
* An environment map (torch's acos and jnp's differ in the last bit on
  some directions) and soft visibility/primary are held to rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from ray_tracer_tpu.core.rays import RayBatch as JaxRays  # noqa: E402
from ray_tracer_tpu.models.materials import MaterialTable as JaxMaterials  # noqa: E402
from ray_tracer_tpu.models.scenes import Scene as JaxScene  # noqa: E402
from ray_tracer_tpu.parallel import shard as jax_shard  # noqa: E402
from ray_tracer_tpu.render import pathtrace as jax_pt  # noqa: E402
from ray_tracer_tpu.render import renderer as jax_renderer  # noqa: E402
from ray_tracer_tpu.models import scenes as jax_scenes  # noqa: E402
from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: E402
from ray_tracer_tpu_torch.models.materials import MaterialTable  # noqa: E402
from ray_tracer_tpu_torch.models.scenes import gradcheck_scene  # noqa: E402
from ray_tracer_tpu_torch.ops.camera import camera_rays  # noqa: E402
from ray_tracer_tpu_torch.parallel import shard  # noqa: E402
from ray_tracer_tpu_torch.render import pathtrace as pt  # noqa: E402
from ray_tracer_tpu_torch.render.renderer import prepare  # noqa: E402

SIZE = 16
D = 2  # shards the fake orbits emulate
ENV = np.linspace(5.0, 80.0, 4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)


def _bits(got, want, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
        keep = ~np.isnan(want)
        u = np.uint32 if got.dtype.itemsize == 4 else np.uint64
        np.testing.assert_array_equal(got[keep].view(u), want[keep].view(u), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def inputs():
    """The gradcheck scene's numpy arrays, its padded soup, random corner
    payloads and the 16x16 camera rays."""
    scene, cfg = gradcheck_scene(SIZE, SIZE, device="cpu")
    rays = camera_rays(cfg.camera, device="cpu")
    v0, v1, v2 = (x.numpy() for x in scene.triangle_soa())
    f = v0.shape[0]
    rng = np.random.default_rng(5)
    return dict(
        scene=scene, cfg=cfg, rays=[x.numpy() for x in rays], v=(v0, v1, v2),
        fmat=scene.face_material.numpy().astype(np.int32),
        fvn=rng.normal(size=(f, 3, 3)).astype(np.float32),
        fuv=rng.uniform(size=(f, 3, 2)).astype(np.float32),
        fhuv=rng.uniform(size=(f,)) > 0.3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _local_pair(inputs, sl, offset, t_lower, ddt, extras=True, maxt=None):
    """Both packages' all-pairs hops over the faces sl."""
    o, d, mint, mx = inputs["rays"]
    if maxt is not None:
        mx = np.where(np.arange(mx.shape[0]) % 3 == 0, np.float32(maxt), mx).astype(np.float32)
    v0, v1, v2 = (x[sl] for x in inputs["v"])
    ex = (inputs["fvn"][sl], inputs["fuv"][sl], inputs["fhuv"][sl]) if extras else (None,) * 3
    got = shard._ring_local_best(RayBatch(_t(o), _t(d), _t(mint), _t(mx)), _t(v0), _t(v1),
                                 _t(v2), _t(inputs["fmat"][sl]), offset, t_lower,
                                 {"float32": torch.float32, "float64": torch.float64}[ddt],
                                 extras=tuple(None if e is None else _t(e) for e in ex))
    with jax.disable_jit():
        want = jax_shard._ring_local_best(
            JaxRays(*(jnp.asarray(x) for x in (o, d, mint, mx))), jnp.asarray(v0),
            jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(inputs["fmat"][sl]), offset, t_lower,
            jnp.dtype(ddt), extras=tuple(None if e is None else jnp.asarray(e) for e in ex))
    return got, want


@pytest.mark.parametrize("ddt", ["float32", "float64"])
@pytest.mark.parametrize("t_lower,maxt", [(None, None), (1e-4, 2.5)])
def test_ring_local_best_bitwise(inputs, ddt, t_lower, maxt):
    f = inputs["v"][0].shape[0]
    got, want = _local_pair(inputs, slice(f // 2, f), f // 2, t_lower, ddt, maxt=maxt)
    assert set(got) == set(want)
    for k in want:
        _bits(got[k].numpy(), want[k], k)
    assert got["t"].dtype == {"float32": torch.float32, "float64": torch.float64}[ddt]


@pytest.fixture(scope="module")
def ring_grids():
    """(the port's prepared packed scene, its 2-shard ring grids, the JAX
    package's ring grids of the same scene)."""
    scene, cfg = gradcheck_scene(SIZE, SIZE, device="cpu")
    kw = dict(faithful=False, det_dtype="float32", traversal="packed", fused_shadow=False)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))
    prep = prepare(cfg, scene=scene)
    jscene, jcfg = jax_scenes.gradcheck_scene(SIZE, SIZE)
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, **kw))
    jprep = jax_renderer.prepare(jcfg, scene=jscene)
    return prep, shard.build_ring_grids(prep, D), jax_shard.build_ring_grids(jprep, D)


@pytest.mark.parametrize("stop_first", [False, True])
def test_grid_local_best_bitwise(inputs, ring_grids, stop_first):
    prep, rg, (jarr, jmeta, fp) = ring_grids
    st = fp // D
    sl = slice(st, 2 * st)
    garr, consts = rg.shard(1, "cpu")
    o, d, mint, maxt = inputs["rays"]
    v0, v1, v2 = (x[sl] for x in inputs["v"])
    ex = (inputs["fvn"][sl], inputs["fuv"][sl], inputs["fhuv"][sl])
    got = shard._grid_local_best(RayBatch(_t(o), _t(d), _t(mint), _t(maxt)), 1, garr, rg.meta,
                                 _t(v0), _t(v1), _t(v2), _t(inputs["fmat"][sl]), st, 1e-3,
                                 stop_first, extras=tuple(_t(e) for e in ex), consts=consts)
    with jax.disable_jit():
        want = jax_shard._grid_local_best(
            JaxRays(*(jnp.asarray(x) for x in (o, d, mint, maxt))), 1,
            jax.tree.map(lambda x: x[1], jarr), jmeta, jnp.asarray(v0), jnp.asarray(v1),
            jnp.asarray(v2), jnp.asarray(inputs["fmat"][sl]), st, 1e-3, stop_first,
            extras=tuple(jnp.asarray(e) for e in ex))
    assert set(got) == set(want)
    for k in want:
        _bits(got[k].numpy(), want[k], k)
    assert bool(np.isfinite(want["t"]).any())


def _port_orbit(v, fmat, extras, ddt):
    """The fake orbit of the port: D shards' all-pairs hops merged by the
    orbit's rule, from the orbit's initial best."""
    f = v[0].shape[0]
    st = f // D

    def orbit(rb, t_gate, stop_first):
        z3 = (rb.orig * 0.0).to(torch.float32)
        zi = torch.zeros((rb.count,), dtype=torch.int32)
        best = dict(t=torch.full((rb.count,), float("inf"), dtype=ddt),
                    tid=torch.full_like(zi, 2 ** 31 - 1), mat=zi, tv0=z3, tv1=z3, tv2=z3)
        ex = (None,) * 3 if stop_first else extras
        if ex[0] is not None:
            best.update(vn0=z3, vn1=z3, vn2=z3)
        if ex[1] is not None:
            best.update(uv0=z3[:, :2], uv1=z3[:, :2], uv2=z3[:, :2], huv=zi != 0)
        for s in range(D):
            sl = slice(s * st, (s + 1) * st)
            loc = shard._ring_local_best(rb, v[0][sl], v[1][sl], v[2][sl], fmat[sl], s * st,
                                         t_gate, ddt,
                                         extras=tuple(None if e is None else e[sl] for e in ex))
            better = (loc["t"] < best["t"]) | ((loc["t"] == best["t"])
                                               & (loc["tid"] < best["tid"]))
            best = {k: torch.where(better[:, None] if best[k].dim() == 2 else better,
                                   loc[k], best[k]) for k in best}
        return rb, best

    return orbit


def _jax_orbit(v, fmat, extras, ddt):
    f = v[0].shape[0]
    st = f // D

    def orbit(rb, t_gate, stop_first):
        z3 = (rb.orig * 0.0).astype(jnp.float32)
        zi = jnp.zeros((rb.count,), jnp.int32)
        best = dict(t=jnp.full((rb.count,), jnp.inf, ddt),
                    tid=zi + jnp.iinfo(jnp.int32).max, mat=zi, tv0=z3, tv1=z3, tv2=z3)
        ex = (None,) * 3 if stop_first else extras
        if ex[0] is not None:
            best.update(vn0=z3, vn1=z3, vn2=z3)
        if ex[1] is not None:
            best.update(uv0=z3[:, :2], uv1=z3[:, :2], uv2=z3[:, :2], huv=zi != 0)
        for s in range(D):
            sl = slice(s * st, (s + 1) * st)
            loc = jax_shard._ring_local_best(
                rb, v[0][sl], v[1][sl], v[2][sl], fmat[sl], s * st, t_gate, ddt,
                extras=tuple(None if e is None else e[sl] for e in ex))
            better = (loc["t"] < best["t"]) | ((loc["t"] == best["t"])
                                               & (loc["tid"] < best["tid"]))
            best = {k: jnp.where(better[:, None] if best[k].ndim == 2 else better,
                                 loc[k], best[k]) for k in best}
        return rb, best

    return orbit


SHADE_CASES = {
    "bounces": dict(render=dict(max_bounces=2), reflective=True),
    "serial": dict(render=dict(shading="serial", max_bounces=1), reflective=True),
    "features": dict(render=dict(normal_mode="smooth", texture="checker", texture_scale=4.0,
                                 shadow_samples=4, light_radius=0.3, max_bounces=1),
                     reflective=True, extra_light=True),
    "env": dict(render=dict(max_bounces=1), reflective=True, env=True),
    "soft": dict(render=dict(soft_visibility=0.05, soft_primary=0.05)),
}


def _shade_inputs(inputs, case):
    """Both packages' (rays, orbit, rcfg, materials, light, kwargs) of a
    case, and the port's trainable leaves."""
    spec = SHADE_CASES[case]
    cfg = inputs["cfg"]
    rcfg = dataclasses.replace(cfg.render, **spec["render"])
    jcfg = jax_scenes.gradcheck_scene(SIZE, SIZE)[1]
    jrcfg = dataclasses.replace(jcfg.render, **spec["render"])
    m = inputs["scene"].materials
    base = {k: getattr(m, k).numpy() for k in MaterialTable._fields}
    if spec.get("reflective"):
        base["reflective"] = np.array([False, True])
        base["km"] = np.array([0.0, 0.6], np.float32)
    ex = (inputs["fvn"], inputs["fuv"], inputs["fhuv"])
    light = inputs["scene"].light_pos.numpy()
    li = inputs["scene"].light_intensity.numpy()
    kw, jkw = {}, {}
    if spec.get("env"):
        kw["env_image"], jkw["env_image"] = _t(ENV), jnp.asarray(ENV)
    if spec.get("extra_light"):
        elp, eli = np.array([[-4.0, 6.0, -2.0]], np.float32), np.array([1.0], np.float32)
        kw.update(extra_light_pos=_t(elp), extra_light_intensity=_t(eli))
        jkw.update(extra_light_pos=jnp.asarray(elp), extra_light_intensity=jnp.asarray(eli))
    ddt = torch.float32
    port = dict(rays=RayBatch(*(_t(x) for x in inputs["rays"])), rcfg=rcfg,
                materials=MaterialTable(**{k: _t(v) for k, v in base.items()}),
                light_pos=_t(light), light_intensity=_t(li), kw=kw,
                verts=inputs["scene"].verts, faces=inputs["scene"].faces,
                extras=tuple(_t(e) for e in ex), fmat=_t(inputs["fmat"]), ddt=ddt)
    jax_ = dict(rays=JaxRays(*(jnp.asarray(x) for x in inputs["rays"])), rcfg=jrcfg,
                materials=JaxMaterials(**{k: jnp.asarray(v) for k, v in base.items()}),
                light_pos=jnp.asarray(light), light_intensity=jnp.asarray(li), kw=jkw,
                verts=jnp.asarray(inputs["scene"].verts.numpy()),
                faces=jnp.asarray(inputs["scene"].faces.numpy().astype(np.int32)),
                extras=tuple(jnp.asarray(e) for e in ex),
                fmat=jnp.asarray(inputs["fmat"]), ddt=jnp.float32)
    return port, jax_


def _port_shade(p, verts, materials, light_pos):
    v = tuple(verts.index_select(0, p["faces"][:, k]) for k in range(3))
    orbit = _port_orbit(v, p["fmat"], p["extras"], p["ddt"])
    return shard._ring_shade(p["rays"], orbit, p["rcfg"], materials, light_pos,
                             p["light_intensity"], textured=p["rcfg"].texture != "none",
                             **p["kw"])


def _jax_shade(j, verts, materials, light_pos):
    v = tuple(verts[j["faces"][:, k]] for k in range(3))
    orbit = _jax_orbit(v, j["fmat"], j["extras"], j["ddt"])
    return jax_shard._ring_shade(j["rays"], orbit, j["rcfg"], materials, light_pos,
                                 j["light_intensity"], textured=j["rcfg"].texture != "none",
                                 tex_image=None, **j["kw"])


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_ring_shade_vs_jax(inputs, case):
    p, j = _shade_inputs(inputs, case)
    with torch.no_grad():
        got = _port_shade(p, p["verts"], p["materials"], p["light_pos"]).numpy()
    with jax.disable_jit():
        want = np.asarray(_jax_shade(j, j["verts"], j["materials"], j["light_pos"]))
    assert np.isfinite(got).all() and got.max() > 0
    if case in ("soft", "env"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        _bits(got, want)


@pytest.mark.parametrize("case", ["bounces", "features"])
def test_ring_shade_gradients_vs_jax(inputs, case):
    p, j = _shade_inputs(inputs, case)
    target = np.full((SIZE * SIZE, 3), 40.0, np.float32)
    leaves = {"verts": p["verts"].detach().clone(),
              "base_color": p["materials"].base_color.clone(),
              "km": p["materials"].km.clone(), "light_pos": p["light_pos"].clone()}
    for x in leaves.values():
        x.requires_grad_(True)
    mats = p["materials"]._replace(base_color=leaves["base_color"], km=leaves["km"])
    colors = _port_shade(p, leaves["verts"], mats, leaves["light_pos"])
    (((colors - _t(target)) / 255.0) ** 2).sum().backward()

    def loss(verts, base_color, km, light_pos):
        mats = j["materials"]._replace(base_color=base_color, km=km)
        c = _jax_shade(j, verts, mats, light_pos)
        return jnp.sum(((c - target) / 255.0) ** 2)

    with jax.disable_jit():
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
            j["verts"], j["materials"].base_color, j["materials"].km, j["light_pos"])
    for (name, leaf), want in zip(leaves.items(), grads):
        g, w = leaf.grad.numpy(), np.asarray(want)
        scale = float(np.abs(w).max())
        assert scale > 0, name
        excess = float((np.abs(g - w) - 1e-4 * np.abs(w)).max())
        assert excess <= 1e-6 * scale, (name, excess, scale)


class _FakeTracer:
    """One fake ring tracer for each package: the fake orbit over the
    gradcheck soup, carrying the corner normals and uvs."""

    def __init__(self, orbit, eps, carries, isfinite, f32):
        self.orbit, self.eps, self.carries = orbit, eps, carries
        self.isfinite, self.f32 = isfinite, f32

    def trace(self, rb, t_gate):
        _, b = self.orbit(rb, t_gate, False)
        payload = {k: b[k] for k in ("vn0", "vn1", "vn2", "uv0", "uv1", "uv2", "huv") if k in b}
        return (self.isfinite(b["t"]), self.f32(b["tv0"]), self.f32(b["tv1"]),
                self.f32(b["tv2"]), b["mat"], payload)

    def occlude(self, rb):
        _, b = self.orbit(rb, self.eps, True)
        return self.isfinite(b["t"])


GI_CASES = {
    "depth0": dict(gi_samples=3, gi_depth=0),
    "depth0_features": dict(gi_samples=2, gi_depth=0, normal_mode="smooth", texture="checker",
                            texture_scale=4.0),
    "depth1": dict(gi_samples=2, gi_depth=1, normal_mode="smooth"),
}


@pytest.mark.parametrize("case", list(GI_CASES))
def test_pathtrace_tracer_vs_jax(inputs, case):
    p, j = _shade_inputs(inputs, "bounces")
    cfg = dataclasses.replace(inputs["cfg"], render=dataclasses.replace(
        inputs["cfg"].render, **GI_CASES[case]))
    jcfg0 = jax_scenes.gradcheck_scene(SIZE, SIZE)[1]
    jcfg = dataclasses.replace(jcfg0, render=dataclasses.replace(jcfg0.render,
                                                                 **GI_CASES[case]))
    carries = ("smooth", "uv")
    eps = cfg.render.shadow_eps
    pv = tuple(p["verts"].index_select(0, p["faces"][:, k]) for k in range(3))
    jv = tuple(j["verts"][j["faces"][:, k]] for k in range(3))
    ptr = _FakeTracer(_port_orbit(pv, p["fmat"], p["extras"], torch.float32), eps, carries,
                      torch.isfinite, lambda x: x.to(torch.float32))
    jtr = _FakeTracer(_jax_orbit(jv, j["fmat"], j["extras"], jnp.float32), eps, carries,
                      jnp.isfinite, lambda x: x.astype(jnp.float32))
    # the environment map at depth 1 only: its acos differs from jnp's in
    # the last bit on some directions (test_torch_appearance.py)
    env = GI_CASES[case]["gi_depth"] > 0
    stub = shard.ring_scene_stub(inputs["scene"]._replace(
        materials=p["materials"], env_image=_t(ENV) if env else None))
    jstub = JaxScene(verts=jnp.zeros((1, 3), jnp.float32), faces=jnp.zeros((1, 3), jnp.int32),
                     face_material=jnp.zeros((1,), jnp.int32), materials=j["materials"],
                     light_pos=j["light_pos"], light_intensity=j["light_intensity"],
                     env_image=jnp.asarray(ENV) if env else None)
    with torch.no_grad():
        got = pt.pathtrace_rays(p["rays"], stub, None, None, cfg, tracer=ptr).numpy()
    with jax.disable_jit():
        want = np.asarray(jax_pt.pathtrace_rays(j["rays"], jstub, None, None, jcfg,
                                                tracer=jtr))
    assert np.isfinite(got).all() and got.max() > 0
    if GI_CASES[case]["gi_depth"] == 0:
        _bits(got, want)
    else:
        assert (np.abs(got - want) <= 1e-3).all(axis=-1).mean() > 0.9
    ptr.carries = ("uv",)
    if cfg.render.normal_mode == "smooth":
        with pytest.raises(NotImplementedError, match="corner-normal"):
            pt.pathtrace_rays(p["rays"], stub, None, None, cfg, tracer=ptr)
