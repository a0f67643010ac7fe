"""Multi-device execution on `torch.distributed`: one process a device.

Counterpart of `ray_tracer_tpu/parallel/`:

  * `mesh`        — DeviceMesh construction ("rays" x "tris" axes);
  * `multihost`   — the process group, host-0 output, tile bounds;
  * `collectives` — gathers, sums, the hit min-reduce, the ring shift
                    and the ring orbit's differentiable hop (`ring_pass`);
  * `shard`       — `render_sharded` (the Whitted and GI waves sharded
                    by queue arithmetic), `trace_sharded`, the
                    triangle-sharded all-pairs intersect, and the geometry
                    sharded by ring orbits (`build_ring_grids`,
                    `intersect_ring_sharded`, `render_sharded_geometry`,
                    `ring_loss`, `trace_ring`);
  * `scaling`     — throughput against device count, work balance.
"""

from ray_tracer_tpu_torch.parallel.mesh import make_mesh
from ray_tracer_tpu_torch.parallel.shard import render_sharded

__all__ = ["make_mesh", "render_sharded"]
