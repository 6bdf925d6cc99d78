"""Functional dense-grid -> SVO chunk builder, batched on the device.

Port of ``voxelraytracing_tpu/ops/svo_build.py``. The whole batch of
chunks is built in one pass of tensor ops, without an allocator:

  1. Reduce the dense ``[32,32,32]`` voxel grids into per-level "uniform
     value" pyramids (a segmented all-equal reduction per octant).
  2. Lay out nodes in breadth-first order: the root at address 0, then the
     8-child blocks of every split node, level by level, in flat scan
     order. Addresses are exclusive prefix sums over the split masks.

The layout is compact (exactly ``1 + 8 * n_splits`` nodes) and word for
word the JAX builder's and the native ``dense_to_svo``'s. The JAX builder
is XLA outside any Pallas kernel, so these tensor ops on the card are its
port; the JAX ``vmap`` is the leading batch axis here.

JAX scatters the nodes with ``mode="drop"`` and sends the writes of cells
that do not exist to the out-of-range address ``NODES_PER_CHUNK``. Here
each chunk's row has one spare slot at that address, which takes those
writes and is cut off: a dropped write never lands on a real node.
"""

import numpy as np
import torch

from ..core import nodes as nodefmt
from ..core.constants import CHUNK_DEPTH, CHUNK_SIZE, NODES_PER_CHUNK


def _octant_view(level_arr):
    """[B,2S,2S,2S] -> [B,S,S,S,8] with last axis ordered child = dx + 2*dy
    + 4*dz."""
    b, s = level_arr.shape[0], level_arr.shape[1] // 2
    v = level_arr.reshape(b, s, 2, s, 2, s, 2)
    # axes: (b, xc, dx, yc, dy, zc, dz) -> (b, xc, yc, zc, dz, dy, dx)
    return v.permute(0, 1, 3, 5, 6, 4, 2).reshape(b, s, s, s, 8)


def _up2(x):
    """[B,S,S,S] -> [B,2S,2S,2S], each cell repeated over its octant."""
    return (x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            .repeat_interleave(2, dim=3))


def build_chunk_svo_batch(grids, device="cuda"):
    """Dense voxel grids -> compact SVO node arrays, one row a chunk.

    Args:
      grids: ``[B,32,32,32]`` integer voxel ids (< 2**15), a tensor or a
        NumPy array; moved to ``device`` (the card unless the caller asks
        for the CPU).

    Returns:
      nodes: ``int32[B, NODES_PER_CHUNK]`` widened 16-bit nodes; entries
        past each chunk's count are zero.
      n_nodes: ``int32[B]`` used prefix lengths.
    """
    if not torch.is_tensor(grids):
        grids = torch.from_numpy(np.asarray(grids, np.int32))
    grid = grids.to(device=device, dtype=torch.int32)
    if grid.ndim != 4 or tuple(grid.shape[1:]) != (CHUNK_SIZE,) * 3:
        raise ValueError(f"grids shape {tuple(grid.shape)}, want [B,32,32,32]")
    b, dev = grid.shape[0], grid.device
    i32 = torch.int32

    # --- bottom-up uniformity pyramid ---
    vals = [None] * (CHUNK_DEPTH + 1)
    unis = [None] * (CHUNK_DEPTH + 1)
    vals[CHUNK_DEPTH] = grid
    unis[CHUNK_DEPTH] = torch.ones(grid.shape, dtype=torch.bool, device=dev)
    for lvl in range(CHUNK_DEPTH - 1, -1, -1):
        v8 = _octant_view(vals[lvl + 1])
        u8 = _octant_view(unis[lvl + 1])
        same = (v8 == v8[..., :1]).all(dim=-1)
        unis[lvl] = u8.all(dim=-1) & same
        vals[lvl] = v8[..., 0]

    # --- top-down existence + BFS addressing ---
    out = torch.zeros((b, NODES_PER_CHUNK + 1), dtype=i32, device=dev)
    exists = torch.ones((b, 1, 1, 1), dtype=torch.bool, device=dev)
    addr = torch.zeros((b, 1, 1, 1), dtype=i32, device=dev)
    next_free = torch.ones(b, dtype=i32, device=dev)

    for lvl in range(CHUNK_DEPTH + 1):
        is_split = exists & ~unis[lvl] & (lvl < CHUNK_DEPTH)
        flat_split = is_split.reshape(b, -1).to(i32)
        n_here = flat_split.sum(dim=1, dtype=i32)
        # exclusive prefix sum -> per-split-node child-block offset
        offsets = torch.cumsum(flat_split, dim=1, dtype=i32) - flat_split
        child_base = (next_free[:, None] + 8 * offsets).reshape(is_split.shape)
        node_val = torch.where(is_split, child_base | nodefmt.SPLIT_MASK,
                               vals[lvl] & nodefmt.DATA_MASK)
        # cells that do not exist write the spare slot, cut off below
        scatter_addr = torch.where(exists, addr, NODES_PER_CHUNK)
        out.scatter_(1, scatter_addr.reshape(b, -1).long(),
                     node_val.reshape(b, -1))

        if lvl < CHUNK_DEPTH:
            # children of split nodes exist; child addr = base + dx + 2dy + 4dz
            s2 = 2 * is_split.shape[1]
            ax = torch.arange(s2, dtype=i32, device=dev) & 1
            child_off = (ax[:, None, None] + 2 * ax[None, :, None]
                         + 4 * ax[None, None, :])
            addr = _up2(child_base) + child_off
            exists = _up2(is_split)
            next_free = next_free + 8 * n_here

    return out[:, :NODES_PER_CHUNK].contiguous(), next_free


def build_chunk_svo(grid, device="cuda"):
    """One dense ``[32,32,32]`` grid -> ``(int32[NODES_PER_CHUNK], int32
    scalar)``: :func:`build_chunk_svo_batch` on a batch of one."""
    grid = grid if torch.is_tensor(grid) else np.asarray(grid)
    nodes, n = build_chunk_svo_batch(grid[None], device=device)
    return nodes[0], n[0]
