from ray_tracer_tpu_torch.utils.log import get_logger
from ray_tracer_tpu_torch.utils.timing import measure_mrays

__all__ = ["measure_mrays", "get_logger"]
