from ray_tracer_tpu_torch.render.renderer import (  # noqa: F401
    Prepared,
    prepare,
    render,
    render_rays,
)
