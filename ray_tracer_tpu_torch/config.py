"""Typed configuration for scenes, cameras, lights, materials and rendering.

The port's own copy of `ray_tracer_tpu/config.py`: the same dataclasses,
field names and defaults, so one configuration means one render in both
packages.  Every field is kept; the renderer raises NotImplementedError
for the options this package does not serve yet
(`render/renderer.check_supported`) instead of ignoring them.
`save_scene_config` and `load_scene_config` are the JAX package's JSON
round trip: the same bytes for the same config, so a file written by
either package loads into the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class CameraConfig:
    """Look-at camera (reference: Serial/raytracer.cpp:124-138).  aperture
    > 0 with render.spp > 1 is a thin lens focused at focus_distance (0:
    the distance to the target), one lens point a subsample."""

    position: Vec3 = (3.0, 5.0, 3.0)
    target: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, -1.0, 0.0)
    fov_degrees: float = 45.0
    width: int = 512
    height: int = 512
    aperture: float = 0.0
    focus_distance: float = 0.0


@dataclass(frozen=True)
class LightConfig:
    """Single point light (reference: Serial/raytracer.cpp:87-89)."""

    position: Vec3 = (5.0, -5.0, 2.0)
    intensity: float = 255.0


@dataclass(frozen=True)
class MaterialConfig:
    """Blinn-Phong material (reference: Parallel/geometry.cuh:284-303).
    transmissive/ior make it glass in the path tracer (the Whitted
    render refuses them)."""

    base_color: Vec3 = (255.0, 0.0, 0.0)
    kd: float = 2.0
    ks: float = 5.0e11
    spec_alpha: float = 4.0
    ka: float = 0.2
    km: float = 0.0
    reflective: bool = False
    transmissive: bool = False
    ior: float = 1.5


@dataclass(frozen=True)
class MeshConfig:
    """One OBJ mesh instance in a scene."""

    path: str
    material_index: int = 0
    offset: Vec3 = (0.0, 0.0, 0.0)
    scale: float = 1.0
    has_vt: bool = True


@dataclass(frozen=True)
class GridConfig:
    """Uniform-grid acceleration structure (reference: Serial/grid.h:94-101).

    resolution_multiplier=3 and max_resolution=64 reproduce the reference
    heuristic nVoxels = clamp(delta * 3*cbrt(N)/maxExtent + 1, 1, 64).
    exact_overlap=True SAT-filters each (triangle, voxel) pair; `leap`
    ("box" | "cheb") is the packed layouts' empty-cell leap geometry
    (accel/packed.pack_grid)."""

    resolution_multiplier: float = 3.0
    max_resolution: int = 64
    exact_overlap: bool = False
    leap: str = "box"


@dataclass(frozen=True)
class RenderConfig:
    """End-to-end render settings; see `ray_tracer_tpu.config.RenderConfig`
    for what each knob does.  The port serves:

      * shading "serial" | "parallel", faithful True | False;
      * traversal "csr" (the CSR DDA, kernel B), "brute" (the plain
        all-pairs sweep), "brute_pallas" (the all-pairs kernel A; the
        name is the JAX package's, kept so configs carry over) and
        "packed" (the block-packed grid march, kernel C; faithful=False);
      * the packed path's knobs: packed_block_tris (0 = auto),
        grid_layout "auto" | "inline" | "blocks", scheduler "tiled" |
        "persistent", fused_shadow, probe_chain (blocks layout), and
        queue_order "fifo" | "chord"; wave, pump, refill_retries,
        camera_refill and packed_unroll are accepted and change no ray's
        record, in the JAX package as here; wave, pump and refill_retries
        shape only the JAX lock-step loop, and kernel C's launch on the
        card takes one lane per queued ray (ops/persistent.py);
      * whitted_wave "off" | "auto" | "on": the cross-depth Whitted wave
        (kernel E) for the configs `whitted_wave_eligible` admits, the
        bounce loop elsewhere ("on" raises there), as in the JAX package;
      * spp (spp x spp subsamples a pixel, on the wave and the bounce
        loop), max_bounces, shadow_eps, shadow_scale, background,
        ray_tile, dtype (the camera rays' type, "float32" or "float64"),
        det_dtype, grid.

    Every other knob that changes the JAX package's image must keep its
    default (the renderer raises).  gi_wave applies only with
    gi_samples > 0."""

    shading: str = "serial"  # "serial" | "parallel"
    faithful: bool = True
    traversal: str = "csr"
    packed_block_tris: int = 14
    packed_unroll: int = 1
    grid_layout: str = "auto"
    scheduler: str = "tiled"
    wave: int = 65536
    pump: int = 1
    queue_order: str = "fifo"
    probe_chain: int = 1
    refill_retries: "int | None" = None
    camera_refill: str = "auto"
    soft_visibility: float = 0.0
    soft_primary: float = 0.0
    spp: int = 1
    texture: str = "none"
    texture_scale: float = 8.0
    normal_mode: str = "face"
    shadow_samples: int = 1
    light_radius: float = 0.0
    shadow_sample_batch: int = 1
    gi_samples: int = 0
    gi_depth: int = 2
    gi_sample_batch: int = 4
    gi_fuse_nee: bool = True
    gi_env_nee: bool = False
    gi_specular: bool = True
    gi_wave: str = "off"
    whitted_wave: str = "off"
    fused_shadow: bool = True
    max_bounces: int = 0  # reflection bounces; parallel reference uses 3
    shadow_eps: float = 1e-1  # Serial/geometry.h:2; parallel uses 1e-4
    shadow_scale: float = 0.1
    background: Vec3 = (0.0, 0.0, 0.0)
    # rays per plain-path chunk on the CPU; the card traces a whole batch
    # per kernel launch.  The image does not depend on it.
    ray_tile: int = 16384
    dtype: str = "float32"
    det_dtype: str = "float32"  # "float64" matches the oracle bitwise
    grid: GridConfig = field(default_factory=GridConfig)

    # ---- derived hit/shadow policy (config.py:367-408 of the JAX package)

    @property
    def serial_shading(self) -> bool:
        return self.shading == "serial"

    def primary_gate(self):
        """Hit-update gate for primary rays: None = accept ANY t (the
        faithful serial reference counts behind-origin hits,
        Serial/geometry.h:164-171); the CUDA variant gates t > eps
        always; the fast serial path gates t > 0."""
        if self.serial_shading and self.faithful:
            return None
        return 0.0 if self.serial_shading else self.shadow_eps

    def bounce_gate(self) -> float:
        """Hit-update gate for bounce (depth >= 1) rays: at least eps, so
        a reflected ray cannot re-accept its own origin triangle."""
        pg = self.primary_gate()
        return self.shadow_eps if pg is None else max(pg, self.shadow_eps)

    def shadow_mint(self) -> float:
        """Shadow-ray mint: eps for the serial reference
        (Serial/geometry.h:2); eps + 0.02 for the CUDA variant
        (Parallel/raytracer.cu:502)."""
        return self.shadow_eps if self.serial_shading else self.shadow_eps + 0.02

    def shadow_dir_away_from_light(self) -> bool:
        """The serial reference points the shadow ray AWAY from the light
        (raytracer.cpp:106 — a quirk kept for bit-faithfulness)."""
        return self.serial_shading

    def accepted_hit(self, res):
        """The faithful serial path counts any barycentric pass along the
        walked voxels (any_pass, Serial/geometry.h:162-174); every other
        mode uses the gated nearest hit."""
        return res.any_pass if (self.serial_shading and self.faithful) else res.hit


@dataclass(frozen=True)
class SceneConfig:
    meshes: Tuple[MeshConfig, ...] = ()
    materials: Tuple[MaterialConfig, ...] = (MaterialConfig(),)
    camera: CameraConfig = field(default_factory=CameraConfig)
    light: LightConfig = field(default_factory=LightConfig)
    extra_lights: Tuple[LightConfig, ...] = ()
    render: RenderConfig = field(default_factory=RenderConfig)


# The JAX package's per-scene tuned knobs (ray_tracer_tpu/config.py
# TUNED_KNOBS), with the same keys and values: "serial" = the spot+blub
# scene, "nefertiti" = the dense stand-in, "parallel" = the reflective
# scene, None = the fallback.  They were swept on a TPU; the port keeps
# them so that one --turbo config means one image in both packages.
TUNED_KNOBS = {
    "serial": dict(block_tris=14, rm=2.0, max_res=128, wave=12288, pump=4,
                   exact=True, wwave=False, gi_pump=6),
    "nefertiti": dict(block_tris=14, rm=2.0, max_res=128, wave=4608, pump=4,
                      exact=True, wwave=False),
    "parallel": dict(block_tris=14, rm=2.0, max_res=64, wave=8192, pump=4,
                     exact=True, wwave=True, wwave_pump=10,
                     wwave_wave=12288),
    None: dict(block_tris=0, rm=3.0, max_res=64, wave=8192, pump=2,
               exact=True, wwave=False),
}


def apply_turbo(cfg: SceneConfig, scene_family: "str | None") -> SceneConfig:
    """The tuned production pipeline (ray_tracer_tpu/config.py
    apply_turbo): packed block rows + the persistent wave + auto grid
    layout + SAT-exact grid insertion, with the TUNED_KNOBS row of the
    scene family."""
    k = TUNED_KNOBS.get(scene_family, TUNED_KNOBS[None])
    wwave = bool(k.get("wwave"))
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(
            cfg.render,
            faithful=False, det_dtype="float32",
            traversal="packed", scheduler="persistent",
            gi_wave="auto",
            whitted_wave="auto" if wwave else "off",
            packed_block_tris=k["block_tris"],
            wave=(k.get("wwave_wave", k["wave"])
                  if wwave and cfg.render.gi_samples == 0 else k["wave"]),
            pump=(k.get("gi_pump", k["pump"])
                  if cfg.render.gi_samples > 0
                  else (k.get("wwave_pump", k["pump"]) if wwave
                        else k["pump"])),
            **({"refill_retries": k["retries"]} if "retries" in k else {}),
            grid_layout="auto",
            grid=dataclasses.replace(
                cfg.render.grid,
                resolution_multiplier=k["rm"],
                max_resolution=k["max_res"],
                exact_overlap=k["exact"],
            ),
        ),
    )


# ---------------------------------------------------------------------------
# JSON round trip (ray_tracer_tpu/config.py:520-559)
# ---------------------------------------------------------------------------

_CONFIG_TYPES = {
    "camera": CameraConfig,
    "light": LightConfig,
    "render": RenderConfig,
    "grid": GridConfig,
}


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_dict(cls, data: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        if f.name == "meshes":
            val = tuple(_from_dict(MeshConfig, m) for m in val)
        elif f.name == "materials":
            val = tuple(_from_dict(MaterialConfig, m) for m in val)
        elif f.name == "extra_lights":
            val = tuple(_from_dict(LightConfig, m) for m in val)
        elif f.name in _CONFIG_TYPES and isinstance(val, dict):
            val = _from_dict(_CONFIG_TYPES[f.name], val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[f.name] = val
    return cls(**kwargs)


def save_scene_config(cfg: SceneConfig, path: str) -> None:
    """Write cfg as indented JSON, the JAX package's bytes."""
    with open(path, "w") as fh:
        json.dump(_to_jsonable(cfg), fh, indent=2)


def load_scene_config(path: str) -> SceneConfig:
    """Read a config written by either package's save_scene_config; fields
    the file lacks keep their defaults."""
    with open(path) as fh:
        return _from_dict(SceneConfig, json.load(fh))
