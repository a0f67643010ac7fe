"""Material tables as NamedTuples of tensors (counterpart of
`ray_tracer_tpu/models/materials.py`).

The reference rebuilds its Blinn-Phong material inside every shading call
(Parallel/geometry.cuh:284-303); here the table is (M,) tensors gathered
per hit.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ray_tracer_tpu_torch.config import MaterialConfig
from ray_tracer_tpu_torch.core.vecmath import take


class MaterialTable(NamedTuple):
    base_color: torch.Tensor  # (M,3)
    kd: torch.Tensor  # (M,)
    ks: torch.Tensor
    spec_alpha: torch.Tensor
    ka: torch.Tensor
    km: torch.Tensor
    reflective: torch.Tensor  # (M,) bool

    @staticmethod
    def from_configs(mats: Sequence[MaterialConfig], dtype=torch.float32,
                     device=None) -> "MaterialTable":
        def col(values, dt=dtype):
            return torch.tensor(values, dtype=dt, device=device)

        return MaterialTable(
            base_color=col([m.base_color for m in mats]),
            kd=col([m.kd for m in mats]),
            ks=col([m.ks for m in mats]),
            spec_alpha=col([m.spec_alpha for m in mats]),
            ka=col([m.ka for m in mats]),
            km=col([m.km for m in mats]),
            reflective=col([m.reflective for m in mats], torch.bool),
        )

    def gather(self, index: torch.Tensor) -> "MaterialTable":
        """Per-hit material lookup: (R,) indices -> per-ray material tensors."""
        return MaterialTable(*(take(f, index) for f in self))


# The reference's 4-entry palette (Parallel/raytracer.cu:449-453):
# plane=blue reflective km=0.6, spot=red, blub=dark green reflective
# km=0.9999, spot2=red.
PARALLEL_REFERENCE_MATERIALS = (
    MaterialConfig(base_color=(0.0, 0.0, 255.0), kd=1.0, ks=1.5, spec_alpha=1.25, ka=0.3, reflective=True, km=0.6),
    MaterialConfig(base_color=(255.0, 0.0, 0.0), kd=10.0, ks=10.0, spec_alpha=1.25, ka=0.3, reflective=False, km=0.0),
    MaterialConfig(base_color=(0.0, 20.0, 0.0), kd=10.0, ks=10.0, spec_alpha=1.25, ka=0.3, reflective=True, km=0.9999),
    MaterialConfig(base_color=(255.0, 0.0, 0.0), kd=10.0, ks=10.0, spec_alpha=1.25, ka=0.3, reflective=False, km=0.0),
)

# The serial variant's single implicit material (Serial/raytracer.cpp:83-89).
SERIAL_REFERENCE_MATERIAL = MaterialConfig(
    base_color=(255.0, 0.0, 0.0), kd=2.0, ks=5.0e11, spec_alpha=4.0, ka=0.2,
    reflective=False, km=0.0,
)
