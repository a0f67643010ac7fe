from ray_tracer_tpu_torch.models.materials import MaterialTable  # noqa: F401
from ray_tracer_tpu_torch.models.scenes import (  # noqa: F401
    Scene,
    build_scene,
    flagship_scene,
    gradcheck_scene,
    nefertiti_scene,
    nefertiti_scene_config,
    parallel_scene,
    parallel_scene_config,
    scene_from_numpy,
    serial_scene,
    serial_scene_config,
)
