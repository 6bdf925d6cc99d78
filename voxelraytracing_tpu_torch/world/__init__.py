"""World state containers: node pool, device assembly, demo terrain and
the streaming RenderGrid3 builder (``world/render_grid.py``)."""

from .assemble import assemble_world_slice, chunk_min_corners, grid_cells
from .pool import ChunkAlloc, NodePool, build_world_slice

__all__ = [
    "ChunkAlloc",
    "NodePool",
    "assemble_world_slice",
    "build_world_slice",
    "chunk_min_corners",
    "grid_cells",
]
