from ray_tracer_tpu_torch.io.obj import MeshArrays, load_obj  # noqa: F401
from ray_tracer_tpu_torch.io.png import read_png, write_png  # noqa: F401
from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8, write_ppm  # noqa: F401
