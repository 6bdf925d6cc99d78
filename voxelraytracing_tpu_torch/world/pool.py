"""Host-side node pool: chunk spans inside one flat device buffer.

Port of ``voxelraytracing_tpu/world/pool.py``. The render view of the
world is a single node array plus a root-address table
(``ops/traverse.WorldSlice``). This module manages that array on the
host: a first-fit span allocator with coalescing free-list — semantics of
the reference's ``ChunkAlloc`` (client/src/world.rs:203-257) — plus a
helper to assemble a ``WorldSlice`` from per-chunk node arrays, uploaded
to the caller's device.

Index 0 of the pool is reserved as an air leaf so that unpopulated chunks
(root address 0) read as empty, exactly like the reference's client pool
(client/src/world.rs:272-280, world.rs:154-159).
"""

import numpy as np
import torch

from ..core import nodes as nodefmt
from ..core.constants import CHUNK_INIT_FREE_MEM
from ..ops.traverse import WorldSlice


class ChunkAlloc:
    """First-fit span allocator over ``[1, max_nodes)`` (client/src/world.rs:203-257)."""

    def __init__(self, max_nodes):
        self.max_nodes = int(max_nodes)
        self.free_mem = [[1, self.max_nodes]]

    def status(self):
        total_free = sum(e - s for s, e in self.free_mem)
        return total_free, self.max_nodes

    def alloc_chunk(self, size):
        """Reserve ``size + CHUNK_INIT_FREE_MEM`` nodes; returns (start, end)."""
        req = size + CHUNK_INIT_FREE_MEM
        for span in self.free_mem:
            if span[1] - span[0] >= req:
                start = span[0]
                span[0] += req
                return start, start + req
        raise MemoryError("No available memory for allocating chunk")

    def free_chunk(self, root, size):
        end = root + size
        for span in self.free_mem:
            if span[0] == end:
                span[0] -= size
                return
            if span[1] == root:
                span[1] += size
                return
        self.free_mem.append([root, end])


class NodePool:
    """Flat host mirror of the device node buffer, with per-chunk spans."""

    def __init__(self, max_nodes):
        self.nodes = np.zeros(max_nodes, dtype=np.int32)
        self.nodes[0] = nodefmt.EMPTY_NODE  # reserved air leaf
        self.alloc = ChunkAlloc(max_nodes)
        # chunk_key -> (start, end) span; root address == start
        self.spans = {}

    def insert_chunk(self, key, chunk_nodes):
        """Copy a chunk's (trimmed) node array into the pool; returns root addr.

        Reuses the existing span in place when it still fits, else
        reallocates — mirrors ``ClientWorld::create_chunk``
        (client/src/world.rs:310-335).
        """
        chunk_nodes = np.asarray(chunk_nodes, dtype=np.int32)
        n = len(chunk_nodes)
        span = self.spans.get(key)
        if span is not None and span[1] - span[0] >= n:
            start = span[0]
        else:
            if span is not None:
                self.remove_chunk(key)
            start, end = self.alloc.alloc_chunk(n)
            self.spans[key] = (start, end)
        self.nodes[start : start + n] = chunk_nodes
        return start

    def remove_chunk(self, key):
        span = self.spans.pop(key, None)
        if span is not None:
            self.alloc.free_chunk(span[0], span[1] - span[0])

    def root_of(self, key):
        span = self.spans.get(key)
        return 0 if span is None else span[0]


def build_world_slice(chunks, min_chunk, size_in_chunks, max_nodes=None,
                      device="cuda"):
    """Assemble a WorldSlice from ``{(cx,cy,cz): chunk node array}``, its
    tensors on ``device`` (the card unless the caller asks for the CPU).

    ``min_chunk`` anchors the root grid; chunks outside the window are
    ignored. Returns ``(WorldSlice, NodePool)``; the interactive engine
    maintains a persistent pool instead (``client/world.py``).
    """
    total = 1 + sum(len(np.asarray(c)) + CHUNK_INIT_FREE_MEM for c in chunks.values())
    pool = NodePool(max_nodes or max(total, 4096))
    w = size_in_chunks
    roots = np.zeros(w * w * w, dtype=np.int32)
    mnx, mny, mnz = (int(v) for v in min_chunk)
    for key, cn in chunks.items():
        x, y, z = key
        lx, ly, lz = x - mnx, y - mny, z - mnz
        if not (0 <= lx < w and 0 <= ly < w and 0 <= lz < w):
            continue
        root = pool.insert_chunk(key, cn)
        roots[lx + ly * w + lz * w * w] = root
    world_min = np.array([mnx, mny, mnz], dtype=np.int32) * 32
    return world_slice(pool.nodes, roots, world_min, device=device), pool


def world_slice(nodes, chunk_roots, world_min, device="cuda"):
    """A WorldSlice of host arrays (a node pool, its root table and the
    min corner) copied to ``device`` (the card unless the caller asks for
    the CPU): how the engine hands ``ClientWorld``'s pool to a tracer."""
    def up(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return WorldSlice(nodes=up(nodes), chunk_roots=up(chunk_roots),
                      world_min=up(world_min))
