"""ray_tracer_tpu_torch — the PyTorch/CUDA port of ray_tracer_tpu.

A second package beside the JAX one: the same scenes, configuration and
hit semantics, with plain PyTorch tensor code for the host-side stages and
CUDA C++ kernels written for Hopper (sm_90a) for the traversals, the
cross-depth Whitted wave and the path tracer's cross-depth GI wave.  It
imports torch and numpy only, never jax or ray_tracer_tpu.

    import ray_tracer_tpu_torch as rt
    prep = rt.prepare(rt.serial_scene_config(1024, 1024))   # on cuda
    rt.write_ppm("out.ppm", rt.render(prep).cpu().numpy())

Entry points take `device=` ("cuda" by default; "cpu" runs every kernel's
plain PyTorch version, as the tests do).  The names below `config` and
`__version__` are the JAX package's root API, each imported when first
read; importing the package builds no kernel.
"""

__version__ = "0.1.0"

from ray_tracer_tpu_torch import config  # noqa: F401,E402

__all__ = [
    "config",
    "__version__",
    "SceneConfig",
    "RenderConfig",
    "CameraConfig",
    "LightConfig",
    "MaterialConfig",
    "prepare",
    "render",
    "render_sharded",
    "render_aovs",
    "fit",
    "serial_scene_config",
    "parallel_scene_config",
    "gradcheck_scene",
    "write_ppm",
    "write_png",
]

# each lazily exported name -> the module that defines it
_LAZY = {
    **{name: "ray_tracer_tpu_torch.config"
       for name in ("SceneConfig", "RenderConfig", "CameraConfig", "LightConfig",
                    "MaterialConfig")},
    "prepare": "ray_tracer_tpu_torch.render.renderer",
    "render_sharded": "ray_tracer_tpu_torch.parallel.shard",
    "render_aovs": "ray_tracer_tpu_torch.render.aov",
    "fit": "ray_tracer_tpu_torch.opt.fit",
    **{name: "ray_tracer_tpu_torch.models.scenes"
       for name in ("serial_scene_config", "parallel_scene_config", "gradcheck_scene")},
    "write_ppm": "ray_tracer_tpu_torch.io.ppm",
    "write_png": "ray_tracer_tpu_torch.io.png",
}


def __getattr__(name):
    """The JAX package's root API (`ray_tracer_tpu/__init__.py`), each name
    imported from its module when first read."""
    import importlib

    if name == "render":  # the subpackage, callable as render(prep)
        return importlib.import_module("ray_tracer_tpu_torch.render")
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
