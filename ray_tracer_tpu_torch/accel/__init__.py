from ray_tracer_tpu_torch.accel.grid import (  # noqa: F401
    GridArrays,
    GridMeta,
    UniformGrid,
    build_grid,
    grid_from_numpy,
)
