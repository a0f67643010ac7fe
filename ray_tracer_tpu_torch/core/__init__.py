from ray_tracer_tpu_torch.core.rays import RayBatch  # noqa: F401
from ray_tracer_tpu_torch.core.aabb import AABB  # noqa: F401
