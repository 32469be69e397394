"""Multi-device rendering: a [dp, geo] device mesh, the sharded render, its
training step and the scaling sweep (the JAX package's `parallel/`)."""

from .mesh import DP_AXIS, GEO_AXIS, Mesh, make_mesh, multihost_initialize
from .render import (
    pad_scene_geo,
    render_image_sharded,
    render_image_sharded_jit,
    scene_partition_specs,
)
from .train import TrainState, loss_fn, material_params, train_step

__all__ = [
    "DP_AXIS", "GEO_AXIS", "Mesh", "make_mesh", "multihost_initialize",
    "pad_scene_geo", "render_image_sharded", "render_image_sharded_jit",
    "scene_partition_specs", "TrainState", "loss_fn", "material_params",
    "train_step", "measure_scaling", "scaling_panel",
]


def __getattr__(name):
    # the scaling sweep loads on first use, so `python -m
    # ba_pathtracing_fur_torch.parallel.scaling` runs its module once
    if name in ("measure_scaling", "scaling_panel"):
        from . import scaling
        return getattr(scaling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
