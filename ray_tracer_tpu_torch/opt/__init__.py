"""Inverse rendering: the fit loop and its checkpoints."""
from ray_tracer_tpu_torch.opt.fit import (
    SceneParams,
    image_loss,
    make_train_step,
    merge_scene,
    split_scene,
)

__all__ = [
    "SceneParams",
    "image_loss",
    "make_train_step",
    "merge_scene",
    "split_scene",
]
