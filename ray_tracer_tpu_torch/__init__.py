"""ray_tracer_tpu_torch — the PyTorch/CUDA port of ray_tracer_tpu.

A second package beside the JAX one: the same scenes, configuration and
hit semantics, with plain PyTorch tensor code for the host-side stages and
CUDA C++ kernels written for Hopper (sm_90a) for the traversals, the
cross-depth Whitted wave and the path tracer's cross-depth GI wave.  It
imports torch and numpy only, never jax or ray_tracer_tpu.

    from ray_tracer_tpu_torch.models.scenes import serial_scene_config
    from ray_tracer_tpu_torch.render.renderer import prepare, render
    img = render(prepare(serial_scene_config(1024, 1024)))   # on cuda

Entry points take `device=` ("cuda" by default; "cpu" runs every kernel's
plain PyTorch version, as the tests do).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """`render_sharded` at the package root, imported when first read (the
    JAX package's lazy export)."""
    if name == "render_sharded":
        from ray_tracer_tpu_torch.parallel.shard import render_sharded

        return render_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
