"""Host-side sparse voxel octree: allocator + mutation.

This module is the *functional specification* of the SVO used everywhere else:
the device-side functional chunk builder (``ops/svo_build.py``) and the
native runtime (``core/native.py``) are tested against it. Port of
``voxelraytracing_tpu/core/svo.py`` (host NumPy, unchanged).

Semantics follow the reference engine exactly:

  * ``NodeAlloc`` — free-list allocator that hands out / reclaims aligned
    groups of 8 nodes (one octant set) and coalesces adjacent free ranges
    (reference: common/src/world/mod.rs:213-313).
  * ``Svo.find_node`` — top-down descent comparing the query position against
    each node's center (reference: common/src/world/mod.rs:366-395).
  * ``Svo.set_node`` — splits nodes down to the target depth (copying the
    parent's voxel into all 8 children), writes the leaf, then merges any
    set of 8 identical sibling leaves bottom-up, freeing their slots
    (reference: common/src/world/mod.rs:397-459).

Nodes are stored in an ``int32`` NumPy array of widened 16-bit node values.
"""

from dataclasses import dataclass, field

import numpy as np

from . import nodes as nodefmt
from .constants import CHUNK_DEPTH, CHUNK_SIZE, VOXEL_MAX_VALUE


class SetVoxelError(Exception):
    pass


class PosOutOfBounds(SetVoxelError):
    pass


class OutOfMemory(SetVoxelError):
    pass


class NoChunk(SetVoxelError):
    pass


@dataclass
class NodeAlloc:
    """Free-list allocator over a node span; allocates in groups of 8.

    ``free_mem`` holds half-open ``[start, end)`` ranges. ``last_used_addr``
    tracks the highest address ever handed out, which bounds the prefix of
    the buffer that must be serialized (reference: common/src/world/mod.rs:213-313).
    """

    range_start: int
    range_end: int
    free_mem: list = field(default_factory=list)
    last_used_addr: int = 0

    @classmethod
    def new(cls, used, free):
        """``used`` and ``free`` are (start, end) pairs with used.end == free.start."""
        (us, ue), (fs, fe) = used, free
        assert ue == fs
        return cls(range_start=us, range_end=fe, free_mem=[[fs, fe]], last_used_addr=ue - 1)

    def move_end(self, new_end):
        for free in self.free_mem:
            if free[1] == self.range_end:
                free[1] = new_end
                self.range_end = new_end
                return
        raise ValueError("no free range touching the end of the allocator span")

    def total_free_mem(self):
        return sum(e - s for s, e in self.free_mem)

    def total_used_mem(self):
        return self.range_end - self.total_free_mem()

    def _find_next(self):
        best, best_addr = None, None
        for idx, (s, e) in enumerate(self.free_mem):
            if max(e - s, 0) < 8:
                continue
            if best_addr is None or s < best_addr:
                best_addr, best = s, idx
        return best

    def peek(self):
        idx = self._find_next()
        return None if idx is None else self.free_mem[idx][0]

    def next(self):
        idx = self._find_next()
        if idx is None:
            return None
        free = self.free_mem[idx]
        result = free[0]
        free[0] += 8
        # The reference drops a free span once it is down to a single slot
        # (common/src/world/mod.rs:281-283); slots are only ever handed out
        # in groups of 8, so the stragglers are unusable either way.
        if free[0] + 1 == free[1]:
            self.free_mem.pop(idx)
        self.last_used_addr = max(self.last_used_addr, result + 7)
        return result

    def free(self, addr):
        end = addr + 8
        for free in self.free_mem:
            if free[0] == end:
                free[0] -= 8
                return
            if free[1] == addr:
                free[1] += 8
                return
        self.free_mem.append([addr, end])


def _child_of(pos, center):
    """Octant selection: bit i set iff pos[i] >= center[i]."""
    gt = (np.asarray(pos, dtype=np.float32) >= center).astype(np.int64)
    return int(gt[0] | (gt[1] << 1) | (gt[2] << 2)), gt


@dataclass
class FoundNode:
    idx: int
    depth: int
    center: np.ndarray  # float32[3]
    size: int


class Svo:
    """View of one chunk's octree over a (chunk-relative) node array."""

    def __init__(self, root=0, size=CHUNK_SIZE):
        self.root = root
        self.size = size

    def find_node(self, nodes, pos, max_depth=CHUNK_DEPTH):
        size = self.size
        idx = self.root
        center = np.full(3, size * 0.5, dtype=np.float32)
        depth = 0
        while True:
            node = int(nodes[idx])
            if not nodefmt.is_split(node) or depth == max_depth:
                return FoundNode(idx=idx, depth=depth, center=center.copy(), size=size)
            size //= 2
            child, gt = _child_of(pos, center)
            idx = nodefmt.child_idx_of(node) + child
            center = center + (size * 0.5) * (gt * 2 - 1).astype(np.float32)
            depth += 1

    def node_parent(self, nodes, node_in):
        """Deepest ancestor of ``node_in`` (reference: mod.rs:332-364)."""
        if node_in.depth == 0:
            return None
        size = self.size
        idx = self.root
        center = np.full(3, size * 0.5, dtype=np.float32)
        depth = 0
        while True:
            node = int(nodes[idx])
            if not nodefmt.is_split(node) or depth == node_in.depth - 1:
                return FoundNode(idx=idx, depth=depth, center=center.copy(), size=size)
            size //= 2
            child, gt = _child_of(node_in.center, center)
            idx = nodefmt.child_idx_of(node) + child
            center = center + (size * 0.5) * (gt * 2 - 1).astype(np.float32)
            depth += 1

    def set_node(self, nodes, pos, voxel, target_depth, alloc):
        """Write ``voxel`` at ``pos``/``target_depth``, splitting and merging as needed."""
        node = self.find_node(nodes, pos, target_depth)
        parent_voxel = nodefmt.voxel_of(int(nodes[node.idx]))
        if parent_voxel == voxel:
            return

        while node.depth < target_depth:
            first_child = alloc.next()
            if first_child is None:
                raise OutOfMemory()
            assert first_child < VOXEL_MAX_VALUE
            nodes[first_child : first_child + 8] = nodefmt.leaf(parent_voxel)
            nodes[node.idx] = nodefmt.split(first_child)
            node.size //= 2
            child, gt = _child_of(pos, node.center)
            node.idx = first_child + child
            node.center = node.center + (node.size * 0.5) * (gt * 2 - 1).astype(np.float32)
            node.depth += 1

        nodes[node.idx] = nodefmt.leaf(voxel)

        # Bottom-up merge of 8 identical siblings (reference: mod.rs:442-457).
        while True:
            parent = self.node_parent(nodes, node)
            if parent is None:
                break
            node = parent
            child_base = nodefmt.child_idx_of(int(nodes[node.idx]))
            children = nodes[child_base : child_base + 8]
            if np.all(children == children[0]):
                alloc.free(child_base)
                nodes[node.idx] = nodefmt.leaf(voxel)
            else:
                break


def svo_to_dense(nodes, root=0, size=CHUNK_SIZE):
    """Expand a chunk octree into a dense ``uint16[size,size,size]`` voxel grid.

    Test/debug oracle — iterative, host-only.
    """
    out = np.zeros((size, size, size), dtype=np.uint16)
    # stack of (idx, min_corner, size)
    stack = [(root, np.zeros(3, dtype=np.int64), size)]
    while stack:
        idx, mn, sz = stack.pop()
        node = int(nodes[idx])
        if not nodefmt.is_split(node) or sz == 1:
            out[mn[0] : mn[0] + sz, mn[1] : mn[1] + sz, mn[2] : mn[2] + sz] = nodefmt.voxel_of(node)
            continue
        base = nodefmt.child_idx_of(node)
        half = sz // 2
        for child in range(8):
            off = np.array([child & 1, (child >> 1) & 1, (child >> 2) & 1], dtype=np.int64) * half
            stack.append((base + child, mn + off, half))
    return out


def dense_to_svo_host(grid, buffer=None):
    """Host oracle for the device chunk builder: dense grid -> (nodes, n_used).

    Builds by repeated ``set_node`` into a fresh buffer, exactly like the
    reference's worldgen does (server/src/world/gen.rs:204-236), then trims to
    ``last_used_addr + 1``. Slow; tests only.
    """
    grid = np.asarray(grid)
    n = VOXEL_MAX_VALUE
    nodes = np.zeros(n, dtype=np.int32) if buffer is None else buffer
    alloc = NodeAlloc.new((0, 1), (1, n))
    svo = Svo(0, CHUNK_SIZE)
    for x in range(CHUNK_SIZE):
        for y in range(CHUNK_SIZE):
            for z in range(CHUNK_SIZE):
                v = int(grid[x, y, z])
                if v != 0:
                    svo.set_node(nodes, (x, y, z), v, CHUNK_DEPTH, alloc)
    n_used = alloc.last_used_addr + 1
    return nodes[:n_used].copy(), n_used
