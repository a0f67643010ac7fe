import sys
import types

from ray_tracer_tpu_torch.render.renderer import (  # noqa: F401
    Prepared,
    prepare,
    render,
    render_rays,
)


class _CallablePackage(types.ModuleType):
    """At the package root `render` names both this subpackage (the import
    system binds it there once it is imported) and the JAX package's root
    function `render`; calling the subpackage renders, so
    `ray_tracer_tpu_torch.render(prep)` works whatever was imported first."""

    def __call__(self, *args, **kw):
        return render(*args, **kw)


sys.modules[__name__].__class__ = _CallablePackage
