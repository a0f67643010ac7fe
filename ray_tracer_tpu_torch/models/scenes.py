"""Scene representation and the reference scene definitions.

Counterpart of `ray_tracer_tpu/models/scenes.py` (the serial, parallel,
gradcheck, flagship and nefertiti scenes, and the texture and
environment lookups `sample_texture_image`, `texture_factor` and
`sample_env_image`).  A Scene is a NamedTuple of tensors on one device:
indexed geometry (verts + faces), a per-face material index, the
material table, the point light, the OBJ's uvs, and optionally a texture
image, a lat-long environment map, extra point lights and the
dielectric (glass) tables.
Meshes are loaded and concatenated in numpy on the host, and
`scene_from_numpy` takes the same arrays the JAX package's
`scene_from_numpy` takes, so one set of arrays gives both packages the
identical scene.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tracer_tpu_torch.config import (
    CameraConfig,
    LightConfig,
    MaterialConfig,
    MeshConfig,
    RenderConfig,
    SceneConfig,
)
from ray_tracer_tpu_torch.core.vecmath import div_scalar, take
from ray_tracer_tpu_torch.device import resolve_device
from ray_tracer_tpu_torch.io.obj import MeshArrays, load_obj
from ray_tracer_tpu_torch.models import meshes as mesh_gen
from ray_tracer_tpu_torch.models.materials import (
    PARALLEL_REFERENCE_MATERIALS,
    SERIAL_REFERENCE_MATERIAL,
    MaterialTable,
)

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "assets")


def asset(name: str) -> str:
    return os.path.join(ASSET_DIR, name)


class Scene(NamedTuple):
    """Scene tensors on one device: float geometry, integer topology,
    materials and the light.  uvs/uv_faces carry the OBJ's `vt` data
    (None when absent), which RenderConfig.texture samples;
    texture_image is the (Th, Tw, 3) f32 texel grid in [0, 1] of
    texture="image", env_image the (Eh, Ew, 3) f32 lat-long environment
    map in color units (0..255) that misses see instead of the flat
    background (None: the background).  extra_light_pos/_intensity are
    the extra point lights of SceneConfig.extra_lights, and
    transmissive/ior the per-material glass flags and indices of
    refraction, which only the path tracer reads (each None when the
    scene has none)."""

    verts: torch.Tensor  # (V,3) f32
    faces: torch.Tensor  # (F,3) i64
    face_material: torch.Tensor  # (F,) i64
    materials: MaterialTable
    light_pos: torch.Tensor  # (3,)
    light_intensity: torch.Tensor  # ()
    uvs: Optional[torch.Tensor] = None  # (VT,2) f32
    uv_faces: Optional[torch.Tensor] = None  # (F,3) i64, -1 where absent
    texture_image: Optional[torch.Tensor] = None  # (Th,Tw,3) f32
    env_image: Optional[torch.Tensor] = None  # (Eh,Ew,3) f32
    extra_light_pos: Optional[torch.Tensor] = None  # (L,3)
    extra_light_intensity: Optional[torch.Tensor] = None  # (L,)
    transmissive: Optional[torch.Tensor] = None  # (M,) bool
    ior: Optional[torch.Tensor] = None  # (M,) f32

    def sample_texture(self, uv: torch.Tensor) -> torch.Tensor:
        """Bilinear wrap-mode sample of this scene's texture: (R,2) uv ->
        (R,3) rgb."""
        if self.texture_image is None:
            raise ValueError("scene has no texture_image")
        return sample_texture_image(self.texture_image, uv)

    def sample_env(self, dirn: torch.Tensor) -> torch.Tensor:
        """Lat-long lookup of this scene's environment map: (R,3) unit
        directions -> (R,3) color."""
        if self.env_image is None:
            raise ValueError("scene has no env_image")
        return sample_env_image(self.env_image, dirn)

    def interpolate_uv(self, tri: torch.Tensor, beta: torch.Tensor,
                       gamma: torch.Tensor) -> torch.Tensor:
        """Barycentric uv at hits: (R,) tri ids + (R,) beta/gamma -> (R,2)."""
        if self.uvs is None or self.uv_faces is None:
            raise ValueError("scene has no uv data")
        f = torch.clamp(self.uv_faces[tri], min=0)
        u0, u1, u2 = self.uvs[f[:, 0]], self.uvs[f[:, 1]], self.uvs[f[:, 2]]
        alpha = 1.0 - beta - gamma
        return alpha[:, None] * u0 + beta[:, None] * u1 + gamma[:, None] * u2

    @property
    def device(self) -> torch.device:
        return self.verts.device

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def triangle_soa(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Gathered per-triangle vertices (F,3) x3."""
        return tuple(take(self.verts, self.faces[:, k]) for k in range(3))


_I32_LIMIT = 2147483648.0  # 2^31, exact in float32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA's convert gives it: NaN -> 0, out-of-range
    values saturate, truncation toward zero (in an int64 tensor)."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    x = torch.clamp(x, -_I32_LIMIT, _I32_LIMIT).to(torch.int64)
    return torch.clamp(x, -(1 << 31), (1 << 31) - 1)


def _bilinear(img: torch.Tensor, iv0, iu0, iv1, iu1, fu, fv) -> torch.Tensor:
    """The four texels' blend, u first: top + (bot - top) * fv (texels
    gathered as rows of the flat image, `take`)."""
    flat, w = img.reshape(-1, img.shape[-1]), img.shape[1]
    c00, c01 = take(flat, iv0 * w + iu0), take(flat, iv0 * w + iu1)
    c10, c11 = take(flat, iv1 * w + iu0), take(flat, iv1 * w + iu1)
    top = c00 + (c01 - c00) * fu[:, None]
    bot = c10 + (c11 - c10) * fu[:, None]
    return top + (bot - top) * fv[:, None]


def sample_texture_image(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap-mode sample of an (H,W,3) texture at (R,2) uv -> (R,3):
    v = 0 is the image's bottom row (the OBJ convention), texels are
    centred at (i + 0.5) / size, and coordinates wrap (repeat tiling)
    through a floor-mod of the saturating int32 cast."""
    th, tw = tex.shape[0], tex.shape[1]
    u = uv[:, 0] * tw - 0.5
    v = (1.0 - uv[:, 1]) * th - 0.5
    u0f, v0f = torch.floor(u), torch.floor(v)
    iu0 = torch.remainder(_to_i32(u0f), tw)
    iv0 = torch.remainder(_to_i32(v0f), th)
    return _bilinear(tex, iv0, iu0, torch.remainder(iv0 + 1, th),
                     torch.remainder(iu0 + 1, tw), u - u0f, v - v0f)


def texture_factor(uv, has_uv, hit, mode: str, scale, tex_image, rgb_dtype):
    """The one texture-factor expression, shared by the bounce loop, the
    segment integrator and the GI wave's plain version (kernel F has it
    in csrc/texture.cuh): the checker pattern or the bilinear image
    sample, 1 where a lane has no uv or no hit.  Returns the (R,1) or
    (R,3) factor that multiplies base_color."""
    n = torch.tensor(scale, dtype=uv.dtype, device=uv.device)
    keep = has_uv & hit
    if mode == "checker":
        checker = torch.remainder(torch.floor(uv[:, 0] * n) + torch.floor(uv[:, 1] * n), 2.0)
        return torch.where(keep, 1.0 - 0.5 * checker, torch.ones_like(checker))[:, None]
    if mode == "image":
        if tex_image is None:
            raise ValueError('cfg.render.texture == "image" but the scene has no '
                             "texture_image")
        uv_s = torch.where(hit[:, None], uv, torch.zeros_like(uv)) * n
        rgb = sample_texture_image(tex_image, uv_s).to(rgb_dtype)
        return torch.where(keep[:, None], rgb, torch.ones_like(rgb))
    raise ValueError(f"unknown texture mode {mode!r}")


def sample_env_image(env: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """Lat-long (equirectangular) lookup: (R,3) unit directions -> (R,3)
    color.  u = azimuth around +y (wraps), v = polar angle from +y,
    clamped at the pole texel centres; bilinear.  The divides by 2pi and
    pi are true divides (vecmath.div_scalar).  A constant map returns its
    constant exactly."""
    th, tw = env.shape[0], env.shape[1]
    u = div_scalar(torch.atan2(dirn[:, 2], dirn[:, 0]), 2.0 * np.pi) + 0.5
    v = div_scalar(torch.acos(torch.clamp(dirn[:, 1], -1.0, 1.0)), np.pi)
    uu = u * tw - 0.5
    vv = torch.clamp(v * th - 0.5, 0.0, th - 1.0)
    u0f, v0f = torch.floor(uu), torch.floor(vv)
    iu0 = torch.remainder(_to_i32(u0f), tw)
    iv0 = torch.clamp(_to_i32(v0f), 0, th - 1)
    return _bilinear(env, iv0, iu0, torch.clamp(iv0 + 1, 0, th - 1),
                     torch.remainder(iu0 + 1, tw), uu - u0f, vv - v0f)


def concat_mesh_arrays(parts: Sequence[Tuple[MeshArrays, int]]):
    """Host-side concat -> (verts (V,3) f32, faces (F,3) i32, fmat (F,) i32,
    uvs (VT,2) f32, uv_faces (F,3) i32 with -1 for faces without vt)."""
    if not parts:
        raise ValueError(
            "no meshes to concatenate: this SceneConfig is not "
            "self-describing (procedural scenes like gradcheck carry their "
            "geometry in the Scene object; pass scene= to prepare())"
        )
    all_verts = []
    all_faces = []
    all_fmat = []
    all_uvs = []
    all_uvf = []
    voffset = 0
    uvoffset = 0
    for mesh, midx in parts:
        nf = mesh.faces.shape[0]
        all_verts.append(mesh.verts)
        all_faces.append(mesh.faces + voffset)
        all_fmat.append(np.full((nf,), midx, dtype=np.int32))
        if mesh.uvs.size and mesh.uv_faces.size:
            all_uvs.append(mesh.uvs)
            # -1 rows mark faces without vt and keep their -1
            all_uvf.append(
                np.where(mesh.uv_faces >= 0, mesh.uv_faces + uvoffset, -1)
            )
            uvoffset += mesh.uvs.shape[0]
        else:
            all_uvf.append(np.full((nf, 3), -1, dtype=np.int32))
        voffset += mesh.verts.shape[0]
    uvs = (np.concatenate(all_uvs, axis=0).astype(np.float32)
           if all_uvs else np.zeros((1, 2), np.float32))
    return (
        np.concatenate(all_verts, axis=0).astype(np.float32),
        np.concatenate(all_faces, axis=0).astype(np.int32),
        np.concatenate(all_fmat, axis=0),
        uvs,
        np.concatenate(all_uvf, axis=0).astype(np.int32),
    )


def host_geometry(scene: Scene):
    """(verts (V,3) f32, faces (F,3) i32) of the scene in numpy (the JAX
    package's `host_geometry`; a copy from the device)."""
    return (scene.verts.detach().to("cpu", torch.float32).numpy(),
            scene.faces.cpu().numpy().astype(np.int32))


def scene_from_numpy(
    verts: np.ndarray,
    faces: np.ndarray,
    fmat: np.ndarray,
    materials: Sequence[MaterialConfig],
    light: LightConfig,
    uvs: Optional[np.ndarray] = None,
    uv_faces: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device=None,
    texture_image: Optional[np.ndarray] = None,
    env_image: Optional[np.ndarray] = None,
    extra_lights: Sequence[LightConfig] = (),
) -> Scene:
    """The same arguments as the JAX package's `scene_from_numpy`, plus
    the device (cuda unless "cpu" is asked for) and the scene's optional
    texture image and environment map as (H, W, 3) arrays (the JAX scene
    takes them by `_replace`).  The extra lights' tables, and the glass
    tables when some material is transmissive, are None otherwise."""
    dev = resolve_device(device)
    glass = any(m.transmissive for m in materials)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def image(a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev))

    return Scene(
        verts=torch.as_tensor(np.asarray(verts), device=dev).to(dtype),
        faces=idx(faces),
        face_material=idx(fmat),
        materials=MaterialTable.from_configs(materials, dtype=dtype, device=dev),
        light_pos=torch.tensor(light.position, dtype=dtype, device=dev),
        light_intensity=torch.tensor(light.intensity, dtype=dtype, device=dev),
        uvs=(torch.as_tensor(np.asarray(uvs), device=dev).to(dtype)
             if uvs is not None else None),
        uv_faces=idx(uv_faces) if uv_faces is not None else None,
        texture_image=image(texture_image),
        env_image=image(env_image),
        **extra_light_tables(extra_lights, dtype, dev),
        transmissive=(torch.tensor([m.transmissive for m in materials], dtype=torch.bool,
                                   device=dev) if glass else None),
        ior=(torch.tensor([m.ior for m in materials], dtype=dtype, device=dev)
             if glass else None),
    )


def extra_light_tables(extra_lights: Sequence[LightConfig], dtype, device) -> dict:
    """The Scene fields of extra point lights: extra_light_pos (L,3) and
    extra_light_intensity (L,), None without any."""
    if not extra_lights:
        return dict(extra_light_pos=None, extra_light_intensity=None)
    return dict(
        extra_light_pos=torch.tensor([l.position for l in extra_lights], dtype=dtype,
                                     device=device),
        extra_light_intensity=torch.tensor([l.intensity for l in extra_lights], dtype=dtype,
                                           device=device))


def scene_from_meshes(
    parts: Sequence[Tuple[MeshArrays, int]],
    materials: Sequence[MaterialConfig],
    light: LightConfig,
    dtype=torch.float32,
    device=None,
    extra_lights: Sequence[LightConfig] = (),
) -> Scene:
    """Concatenate (mesh, material_index) parts into one Scene."""
    verts, faces, fmat, uvs, uvf = concat_mesh_arrays(parts)
    return scene_from_numpy(verts, faces, fmat, materials, light, uvs, uvf,
                            dtype=dtype, device=device, extra_lights=extra_lights)


def scene_numpy_arrays(cfg: SceneConfig):
    """Load cfg.meshes and return host numpy arrays
    (verts, faces, fmat, uvs, uv_faces)."""
    parts = []
    for m in cfg.meshes:
        mesh = load_obj(m.path, offset=m.offset, scale=m.scale)
        parts.append((mesh, m.material_index))
    return concat_mesh_arrays(parts)


def build_scene(cfg: SceneConfig, dtype=torch.float32, device=None) -> Scene:
    verts, faces, fmat, uvs, uvf = scene_numpy_arrays(cfg)
    return scene_from_numpy(verts, faces, fmat, cfg.materials, cfg.light,
                            uvs, uvf, dtype=dtype, device=device,
                            extra_lights=cfg.extra_lights)


# ---------------------------------------------------------------------------
# Reference scenes
# ---------------------------------------------------------------------------


def serial_scene_config(width: int = 512, height: int = 512) -> SceneConfig:
    """The serial reference's scene (Serial/raytracer.cpp:191-200):
    spot + blub offset (1.5,0,0), red, camera (3,5,3) fov 45,
    light (5,-5,2) intensity 255."""
    return SceneConfig(
        meshes=(
            MeshConfig(path=asset("spot_triangulated.obj"), material_index=0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=0, offset=(1.5, 0.0, 0.0)),
        ),
        materials=(SERIAL_REFERENCE_MATERIAL,),
        camera=CameraConfig(position=(3, 5, 3), target=(0, 0, 0), up=(0, -1, 0), fov_degrees=45.0, width=width, height=height),
        light=LightConfig(position=(5, -5, 2), intensity=255.0),
        render=RenderConfig(shading="serial", faithful=True, max_bounces=0, shadow_eps=1e-1, shadow_scale=0.1),
    )


def parallel_scene_config(width: int = 64, height: int = 64) -> SceneConfig:
    """The parallel reference's scene (Parallel/raytracer.cu:769-786):
    plane(mat0, +0.4y, x3) + blub(mat1, -2x, x5) + spot(mat1, x5) +
    blub(mat3, +2x, x5); camera (18,18,19) fov 60; light (2,5,0)."""
    return SceneConfig(
        meshes=(
            MeshConfig(path=asset("plane.obj"), material_index=0, offset=(0.0, 0.4, 0.0), scale=3.0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=1, offset=(-2.0, 0.0, 0.0), scale=5.0),
            MeshConfig(path=asset("spot_triangulated.obj"), material_index=1, scale=5.0),
            MeshConfig(path=asset("blub_triangulated.obj"), material_index=3, offset=(2.0, 0.0, 0.0), scale=5.0),
        ),
        materials=PARALLEL_REFERENCE_MATERIALS,
        camera=CameraConfig(position=(18, 18, 19), target=(0, 0, 0), up=(0, -1, 0), fov_degrees=60.0, width=width, height=height),
        light=LightConfig(position=(2, 5, 0), intensity=1.0),
        render=RenderConfig(shading="parallel", faithful=False, max_bounces=3, shadow_eps=1e-4, shadow_scale=0.5),
    )


def gradcheck_mesh_parts():
    """The gradcheck scene's (mesh, material_index) parts: plane + two
    UV spheres."""
    plane = mesh_gen.make_plane(extent=8.0, y=-1.0, density=2)
    sphere_a = mesh_gen.make_uv_sphere(center=(0.0, 0.2, 0.0), radius=0.8, n_lat=12, n_lon=18)
    sphere_b = mesh_gen.make_uv_sphere(center=(1.6, 0.0, 0.8), radius=0.5, n_lat=10, n_lon=14)
    return [(plane, 0), (sphere_a, 1), (sphere_b, 1)]


def gradcheck_scene(width: int = 64, height: int = 64, dtype=torch.float32,
                    device=None):
    """The flat plane + spheres scene with shadow rays -> (scene, cfg)."""
    materials = (
        MaterialConfig(base_color=(90.0, 90.0, 220.0), kd=2.0, ks=4.0, spec_alpha=4.0, ka=0.2),
        MaterialConfig(base_color=(220.0, 60.0, 60.0), kd=2.0, ks=4.0, spec_alpha=4.0, ka=0.2),
    )
    light = LightConfig(position=(4.0, 6.0, 2.0), intensity=1.0)
    scene = scene_from_meshes(gradcheck_mesh_parts(), materials, light,
                              dtype=dtype, device=device)
    cfg = SceneConfig(
        materials=materials,
        camera=CameraConfig(position=(3.0, 3.0, 4.0), target=(0, 0, 0), up=(0, 1, 0), fov_degrees=45.0, width=width, height=height),
        light=light,
        render=RenderConfig(shading="parallel", faithful=False, max_bounces=0, shadow_eps=1e-3, shadow_scale=0.5),
    )
    return scene, cfg


def serial_scene(width: int = 512, height: int = 512, dtype=torch.float32, device=None):
    cfg = serial_scene_config(width, height)
    return build_scene(cfg, dtype=dtype, device=device), cfg


def parallel_scene(width: int = 64, height: int = 64, dtype=torch.float32, device=None):
    cfg = parallel_scene_config(width, height)
    return build_scene(cfg, dtype=dtype, device=device), cfg


def flagship_scene(width: int = 1024, height: int = 1024, dtype=torch.float32, device=None):
    """The primary benchmark's scene: the serial scene at 1024x1024."""
    return serial_scene(width, height, dtype=dtype, device=device)


def nefertiti_mesh_parts(n_lat: int = 256, n_lon: int = 512, with_spot: bool = False):
    """The nefertiti workload's (mesh, material_index) parts: the displaced
    sphere of radius 1.2 standing in for the reference's missing scan
    (261,120 faces at the default resolution), and with_spot the spot
    mesh beside it at (2.6, 0, 0)."""
    parts = [(mesh_gen.make_displaced_sphere(n_lat=n_lat, n_lon=n_lon, radius=1.2), 0)]
    if with_spot:
        parts.append((load_obj(asset("spot_triangulated.obj"), offset=(2.6, 0.0, 0.0)), 1))
    return parts


def nefertiti_scene_config(width: int = 1024, height: int = 1024,
                           with_spot: bool = False) -> SceneConfig:
    """The nefertiti scene's config: two materials, one light, the camera,
    packed traversal."""
    materials = (
        MaterialConfig(base_color=(210.0, 180.0, 140.0), kd=2.0, ks=4.0, spec_alpha=6.0, ka=0.2),
        MaterialConfig(base_color=(200.0, 60.0, 60.0), kd=2.0, ks=4.0, spec_alpha=4.0, ka=0.2),
    )
    light = LightConfig(position=(4.0, 5.0, 3.0), intensity=1.0)
    return SceneConfig(
        materials=materials,
        camera=CameraConfig(position=(0.0, 1.5, 4.5), target=(0.8 if with_spot else 0.0, 0, 0),
                            up=(0, 1, 0), fov_degrees=45.0, width=width, height=height),
        light=light,
        render=RenderConfig(shading="parallel", faithful=False, traversal="packed",
                            max_bounces=0, shadow_eps=1e-3, shadow_scale=0.5, ray_tile=512),
    )


def nefertiti_scene(width: int = 1024, height: int = 1024, n_lat: int = 256, n_lon: int = 512,
                    with_spot: bool = False, dtype=torch.float32, device=None):
    """The dense workload scene (ray_tracer_tpu/models/scenes.py:445) ->
    (scene, cfg): the displaced sphere (and with_spot the spot mesh) under
    `nefertiti_scene_config`."""
    cfg = nefertiti_scene_config(width, height, with_spot)
    scene = scene_from_meshes(nefertiti_mesh_parts(n_lat, n_lon, with_spot), cfg.materials,
                              cfg.light, dtype=dtype, device=device)
    return scene, cfg
