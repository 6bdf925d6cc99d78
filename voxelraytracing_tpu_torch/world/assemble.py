"""Window cell enumeration for batched world builds.

Port of the part of ``voxelraytracing_tpu/world/assemble.py`` that the
device demo builder reads (``grid_cells``, ``chunk_min_corners``), on
torch tensors. ``assemble_world_slice`` packs SVO nodes into a
``WorldSlice``, which the port does not have yet (the SVO tracer slice).
"""

import torch

from ..core.constants import CHUNK_SIZE


def grid_cells(size_in_chunks, device="cuda"):
    """All flat cell indices and their (cx, cy, cz) offsets for a W³
    window: ``(int32[W³], int32[W³, 3])``."""
    w = size_in_chunks
    idx = torch.arange(w * w * w, dtype=torch.int32, device=device)
    x = idx % w
    y = (idx // w) % w
    z = idx // (w * w)
    return idx, torch.stack([x, y, z], dim=-1)


def chunk_min_corners(min_chunk, size_in_chunks, device="cuda"):
    """Voxel-space min corner of every chunk in the window, ``int32[W³, 3]``."""
    _, offs = grid_cells(size_in_chunks, device=device)
    return (torch.as_tensor(min_chunk, dtype=torch.int32, device=device)
            + offs) * CHUNK_SIZE
