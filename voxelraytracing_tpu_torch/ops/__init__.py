"""Device compute of the port: camera, tables, the v2, v3 and v4 marches,
the sky, the path tracers, noise and the SVO build.

The rendering entry points are re-exported here, as the JAX package's
``ops`` does for those of its entry points that are ported.
"""

from .camera import CamData, generate_rays
from .pathtrace3 import path_trace3, path_trace4
from .pathtrace4 import path_trace_fused4
from .sky import ray_sky
from .svo_build import build_chunk_svo, build_chunk_svo_batch
from .wavefront import RenderGrid, build_render_grid_host
from .wavefront2 import trace_wavefront2
from .wavefront3 import (
    build_render_grid3_host,
    empty_frame_cache,
    render_frame3,
    trace_wavefront3,
    trace_wavefront3_rays,
    unpack_rgba8,
)
from .wavefront4 import (
    PreparedGrid4,
    PreparedGrid4Sparse,
    prepare_grid4,
    render_frame4,
    trace_wavefront4,
)

__all__ = [
    "CamData",
    "generate_rays",
    "build_chunk_svo",
    "build_chunk_svo_batch",
    "RenderGrid",
    "build_render_grid_host",
    "build_render_grid3_host",
    "empty_frame_cache",
    "path_trace3",
    "path_trace4",
    "PreparedGrid4",
    "PreparedGrid4Sparse",
    "path_trace_fused4",
    "prepare_grid4",
    "ray_sky",
    "render_frame3",
    "render_frame4",
    "trace_wavefront2",
    "trace_wavefront3",
    "trace_wavefront3_rays",
    "trace_wavefront4",
    "unpack_rgba8",
]
