"""Multi-device rendering: frame rows and samples over a mesh of devices."""

from .render import (
    Mesh,
    ShardedRayTracer,
    make_mesh,
    sharded_accumulate_step,
    sharded_render_frame3,
    sharded_render_frame4,
)

__all__ = ["Mesh", "ShardedRayTracer", "make_mesh", "sharded_accumulate_step",
           "sharded_render_frame3", "sharded_render_frame4"]
