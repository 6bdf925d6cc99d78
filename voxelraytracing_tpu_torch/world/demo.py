"""Self-contained procedural demo worlds.

Port of ``voxelraytracing_tpu/world/demo.py``: Perlin column heights ->
layered stone/earth/grass columns with sea-level water, as a batch of
dense ``[32³]`` chunk grids, built on the device (``demo_chunk_grids``)
or on the host (``demo_chunk_grids_host``, its NumPy twin). The
benchmark world and the port's tests are built from them.
``make_demo_world`` builds the grids' SVOs on the device and assembles
them into a ready-to-trace ``WorldSlice``.
"""

import numpy as np
import torch

from ..core.constants import CHUNK_SIZE
from ..ops import noise
from .assemble import grid_cells

# Demo voxel ids (match the bundled respack's first entries).
AIR, STONE, EARTH, GRASS, WATER = 0, 1, 2, 3, 4

DEMO_STYLES = {
    STONE: {"color": (0.55, 0.55, 0.55), "state": "solid"},
    EARTH: {"color": (0.55, 0.35, 0.15), "state": "solid"},
    GRASS: {"color": (0.30, 0.68, 0.24), "state": "solid"},
    WATER: {"color": (0.12, 0.30, 0.85), "state": "liquid"},
}


def demo_materials(n_voxels=256):
    from ..ops.materials import make_material_table

    return make_material_table(n_voxels, DEMO_STYLES)


def demo_chunk_grids(perm, min_chunk, size_in_chunks, height_scale,
                     sea_level, device="cuda"):
    """Dense voxel grids for every chunk of a W³ window, on ``device``
    (the card unless the caller asks for the CPU).

    Returns ``(grids int32[W³, 32, 32, 32], cells int32[W³])``.
    """
    w = size_in_chunks
    i32, f32 = torch.int32, torch.float32
    cells, offs = grid_cells(w, device=device)
    corners = (torch.as_tensor(np.asarray(min_chunk), dtype=i32,
                               device=device) + offs) * CHUNK_SIZE  # [B,3]

    lx = torch.arange(CHUNK_SIZE, dtype=i32, device=device)
    gx = corners[:, 0, None] + lx[None, :]  # [B,32]
    gz = corners[:, 2, None] + lx[None, :]
    # Column world positions [B,32,32,2] -> heights [B,32,32]
    pos = torch.stack(torch.broadcast_tensors(
        gx[:, :, None].to(f32), gz[:, None, :].to(f32)), dim=-1)
    scale = torch.tensor(height_scale, dtype=f32, device=device)
    h = noise.sample01(perm, pos * 0.01) * scale  # [B, 32(x), 32(z)]
    h = torch.floor(h).to(i32)

    gy = corners[:, 1, None] + lx[None, :]  # [B, 32] global y per layer
    y = gy[:, None, :, None]  # [B, 1, 32(y), 1]
    hh = h[:, :, None, :]  # [B, 32(x), 1, 32(z)]

    grid = torch.where(y < hh - 3, STONE, AIR)
    grid = torch.where((y >= hh - 3) & (y < hh - 1), EARTH, grid)
    grid = torch.where((y >= hh - 1) & (y < hh), GRASS, grid)
    grid = torch.where((grid == AIR) & (y < int(sea_level)), WATER, grid)
    return grid.to(i32), cells


def make_demo_world(seed=7, size_in_chunks=8, min_chunk=(0, 0, 0),
                    device="cuda"):
    """Build a ready-to-trace WorldSlice on ``device`` (the card unless
    the caller asks for the CPU): W³ chunks of layered terrain, their
    SVOs built in one batch, in fixed-stride slots."""
    from ..ops.svo_build import build_chunk_svo_batch
    from .assemble import assemble_world_slice

    perm = torch.from_numpy(noise.make_permutation(seed)).to(device)
    w = size_in_chunks
    grids, cells = demo_chunk_grids(
        perm, min_chunk, w, float(np.float32(w * CHUNK_SIZE * 0.45)),
        int(w * CHUNK_SIZE * 0.28), device=device)
    nodes, _ = build_chunk_svo_batch(grids, device=device)
    world_min = np.asarray(min_chunk, np.int32) * CHUNK_SIZE
    return assemble_world_slice(nodes, cells, world_min, w, device=device)


def demo_chunk_grids_host(perm, min_chunk, size_in_chunks, height_scale, sea_level):
    """NumPy twin of :func:`demo_chunk_grids`.

    Returns ``(grids int32[W³, 32, 32, 32], cells int32[W³])``; grid axes
    are (x, y, z) and cell ``c`` is chunk ``(c % W, c // W % W, c // W²)``.
    """
    w = size_in_chunks
    b = w * w * w
    idx = np.arange(b, dtype=np.int64)
    offs = np.stack([idx % w, (idx // w) % w, idx // (w * w)], axis=-1)
    corners = (np.asarray(min_chunk, np.int64) + offs) * CHUNK_SIZE

    lx = np.arange(CHUNK_SIZE, dtype=np.int64)
    gx = corners[:, 0, None] + lx[None, :]
    gz = corners[:, 2, None] + lx[None, :]
    pos = np.stack(
        np.broadcast_arrays(
            gx[:, :, None].astype(np.float32), gz[:, None, :].astype(np.float32)
        ),
        axis=-1,
    )
    h = noise.sample01_np(np.asarray(perm), pos * 0.01) * float(height_scale)
    h = np.floor(h).astype(np.int64)

    gy = corners[:, 1, None] + lx[None, :]
    y = gy[:, None, :, None]
    hh = h[:, :, None, :]
    grid = np.where(y < hh - 3, STONE, AIR)
    grid = np.where((y >= hh - 3) & (y < hh - 1), EARTH, grid)
    grid = np.where((y >= hh - 1) & (y < hh), GRASS, grid)
    grid = np.where((grid == AIR) & (y < int(sea_level)), WATER, grid)
    return grid.astype(np.int32), idx.astype(np.int32)
