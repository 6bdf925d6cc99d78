"""World builders of the port: the demo terrain (device and host), window
cells and the streaming RenderGrid3 builder."""

from .assemble import chunk_min_corners, grid_cells

__all__ = ["chunk_min_corners", "grid_cells"]
