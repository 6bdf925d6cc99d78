"""Typed coordinate conversions between voxel / chunk / region spaces.

Vectorized equivalents of the reference's const-generic position wrappers
(reference: common/src/world/mod.rs:27-126). All functions accept scalars,
tuples or NumPy arrays of shape ``(..., 3)`` and use floor-division, which
matches Rust's ``div_euclid`` for positive divisors.

Port of ``voxelraytracing_tpu/core/coords.py`` (host NumPy, unchanged).
"""

import numpy as np

from .constants import CHUNK_SIZE, REGION_SIZE


def _as_ivec(pos):
    return np.asarray(pos, dtype=np.int64)


def voxel_to_chunk(pos):
    """VoxelPos -> (ChunkPos, VoxelPosInChunk) (reference: mod.rs:82-89)."""
    p = _as_ivec(pos)
    chunk = np.floor_divide(p, CHUNK_SIZE)
    in_chunk = p - chunk * CHUNK_SIZE
    return chunk, in_chunk


def chunk_to_region(pos):
    """ChunkPos -> (RegionPos, ChunkPosInRegion) (reference: mod.rs:90-96)."""
    p = _as_ivec(pos)
    region = np.floor_divide(p, REGION_SIZE)
    in_region = p - region * REGION_SIZE
    return region, in_region


def chunk_min_voxel(chunk_pos):
    """First voxel of a chunk (reference: mod.rs:98-105)."""
    return _as_ivec(chunk_pos) * CHUNK_SIZE


def chunk_max_voxel(chunk_pos):
    """Last voxel of a chunk, inclusive (reference: mod.rs:106-113)."""
    return _as_ivec(chunk_pos) * CHUNK_SIZE + (CHUNK_SIZE - 1)


def local_to_global(in_chunk, chunk_pos):
    """VoxelPosInChunk + ChunkPos -> VoxelPos (reference: mod.rs:115-120)."""
    return _as_ivec(chunk_pos) * CHUNK_SIZE + _as_ivec(in_chunk)


def region_chunk_to_global(in_region, region_pos):
    """ChunkPosInRegion + RegionPos -> ChunkPos (reference: mod.rs:121-126)."""
    return _as_ivec(region_pos) * REGION_SIZE + _as_ivec(in_region)
