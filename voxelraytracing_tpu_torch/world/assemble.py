"""On-device world assembly from fixed-stride chunk slots.

Port of ``voxelraytracing_tpu/world/assemble.py``, on torch tensors. The
interactive engine manages the node pool host-side (``world/pool.py``,
first-fit spans like the reference client, client/src/world.rs:203-257).
For the on-device pipeline — worldgen -> chunk SVO build -> render —
dynamic allocation is replaced by **fixed-stride chunk slots**: chunk
``i`` of the batch owns pool span ``[1 + i*stride, 1 + (i+1)*stride)``
and its root is ``1 + i*stride``. This needs no pointer fixup because
SVO child indices are chunk-relative — the traversal always reads
``nodes[root + idx]`` (ray_tracer.wgsl:95, ops/traverse.py).

Index 0 of the pool stays a reserved air leaf so empty grid cells (root
0) read as empty space. ``grid_cells`` and ``chunk_min_corners`` enumerate
a window's cells for the batched world builds.
"""

import numpy as np
import torch

from ..core.constants import CHUNK_SIZE, NODES_PER_CHUNK
from ..ops.traverse import WorldSlice


def assemble_world_slice(chunk_nodes, chunk_cells, world_min, size_in_chunks,
                         stride=NODES_PER_CHUNK, device="cuda"):
    """Pack per-chunk node arrays into one pool + root table on ``device``
    (the card unless the caller asks for the CPU).

    Args:
      chunk_nodes: ``int32[B, stride]`` per-chunk nodes (from
        ``build_chunk_svo_batch``; entries past each chunk's used prefix are
        zero and harmless).
      chunk_cells: ``int32[B]`` flat grid cell index ``x + y*W + z*W²`` of
        each chunk (window-local). Cells < 0 mark unused batch slots.
      world_min: ``int32[3]`` voxel coordinate of the window's min corner.
      size_in_chunks: window edge length W.
      stride: per-chunk slot size in nodes.

    Returns a :class:`WorldSlice` with ``nodes: int32[1 + B*stride]``.

    JAX scatters the roots with ``mode="drop"`` and sends unused slots to
    the out-of-range cell ``W³``; here the root table has one spare cell
    there, which takes those writes and is cut off.
    """
    def on(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(device=device, dtype=torch.int32)

    chunk_nodes, chunk_cells = on(chunk_nodes), on(chunk_cells)
    b = chunk_nodes.shape[0]
    w = size_in_chunks
    pool = torch.cat([chunk_nodes.new_zeros(1), chunk_nodes.reshape(-1)])
    roots = torch.zeros(w * w * w + 1, dtype=torch.int32, device=device)
    slot_roots = 1 + stride * torch.arange(b, dtype=torch.int32, device=device)
    cells = torch.where(chunk_cells >= 0, chunk_cells,
                        torch.full_like(chunk_cells, w * w * w))
    roots[cells.long()] = slot_roots
    return WorldSlice(nodes=pool, chunk_roots=roots[: w * w * w].contiguous(),
                      world_min=on(world_min))


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
