"""Client-side world: scrolling chunk window over a flat node pool.

Port of ``voxelraytracing_tpu/client/world.py``; edits run through the
port's native library (``core/native.py``) when it builds, as in JAX.

Mirrors the reference client world model (client/src/world.rs): one flat
node array holds every loaded chunk's SVO in a span handed out by a
first-fit allocator; a dense ``size³`` grid of optional chunks anchored at a
min corner scrolls with the player (shifted-out chunks are freed), and the
per-cell root addresses flatten into the ``chunk_roots`` table the tracers
consume. Voxel edits run through the host SVO (split/merge + per-chunk
allocator) exactly like the reference's in-place edits.
"""

import numpy as np

from ..core import native
from ..core import nodes as nodefmt
from ..core.constants import CHUNK_INIT_FREE_MEM, CHUNK_SIZE, CHUNK_DEPTH
from ..core.math import Aabb
from ..core.svo import NodeAlloc, NoChunk, OutOfMemory, PosOutOfBounds, Svo
from ..world.pool import ChunkAlloc


class Chunk:
    """A loaded chunk: pool span + chunk-relative allocator.

    Edits go through the native C++ SVO core when built (core/native.py),
    else the pure-Python spec — identical semantics either way.
    """

    __slots__ = ("start", "end", "alloc", "native")

    def __init__(self, start, end, used_len):
        self.start = int(start)
        self.end = int(end)
        self.native = native.available()
        # chunk-relative allocator over [used_len, end-start)
        if self.native:
            self.alloc = native.NativeAlloc(used_len, self.end - self.start)
        else:
            self.alloc = NodeAlloc.new(
                (0, used_len), (used_len, self.end - self.start)
            )


class ClientWorld:
    """Flat node pool + scrolling ChunkGrid (client/src/world.rs:203-367)."""

    def __init__(self, center_chunk, max_nodes, size_in_chunks):
        self.max_nodes = int(max_nodes)
        self.nodes = np.zeros(self.max_nodes, dtype=np.int32)
        self.nodes[0] = nodefmt.EMPTY_NODE  # reserved air root for empty cells
        self.alloc = ChunkAlloc(self.max_nodes)
        self.size_in_chunks = int(size_in_chunks)
        c = np.asarray(center_chunk, np.int64)
        self.min_chunk = c - self.size_in_chunks // 2
        self.chunks = {}  # (cx,cy,cz) -> Chunk, only in-window entries

    # ------------------------------------------------------------ window

    @property
    def size_in_voxels(self):
        return self.size_in_chunks * CHUNK_SIZE

    @property
    def min_voxel(self):
        return self.min_chunk * CHUNK_SIZE

    def center_chunk(self):
        return self.min_chunk + self.size_in_chunks // 2

    def in_window(self, cpos):
        p = np.asarray(cpos, np.int64)
        return bool(
            np.all(p >= self.min_chunk)
            and np.all(p < self.min_chunk + self.size_in_chunks)
        )

    def center_chunks(self, anchor):
        """Scroll the window so ``anchor`` is the center chunk; frees
        evicted chunks and returns their positions (world.rs:126-152)."""
        new_min = np.asarray(anchor, np.int64) - self.size_in_chunks // 2
        if np.array_equal(new_min, self.min_chunk):
            return []
        self.min_chunk = new_min
        evicted = [p for p in self.chunks if not self.in_window(p)]
        for p in evicted:
            self.free_chunk(p)
        return evicted

    def resize(self, size_in_chunks):
        """Change the window size, keeping overlapping chunks
        (world.rs:58-88)."""
        if size_in_chunks == self.size_in_chunks:
            return []
        center = self.center_chunk()
        self.size_in_chunks = int(size_in_chunks)
        self.min_chunk = center - self.size_in_chunks // 2
        evicted = [p for p in self.chunks if not self.in_window(p)]
        for p in evicted:
            self.free_chunk(p)
        return evicted

    def empty_chunks(self):
        """Window cells with no chunk data (world.rs:166-183)."""
        w = self.size_in_chunks
        out = []
        for z in range(w):
            for y in range(w):
                for x in range(w):
                    p = (
                        int(self.min_chunk[0]) + x,
                        int(self.min_chunk[1]) + y,
                        int(self.min_chunk[2]) + z,
                    )
                    if p not in self.chunks:
                        out.append(p)
        return out

    def chunk_roots(self):
        """``int32[W³]`` per-cell root node address (0 = empty)."""
        w = self.size_in_chunks
        roots = np.zeros(w * w * w, dtype=np.int32)
        mn = self.min_chunk
        for (x, y, z), chunk in self.chunks.items():
            lx, ly, lz = x - mn[0], y - mn[1], z - mn[2]
            roots[lx + ly * w + lz * w * w] = chunk.start
        return roots

    def populated_count(self):
        return len(self.chunks)

    def node_space_status(self):
        return self.alloc.status()

    def grow_pool(self, max_nodes):
        """Extend the node pool to ``max_nodes``: the chunks keep their
        spans and the new nodes join the free tail."""
        max_nodes = int(max_nodes)
        if max_nodes <= self.max_nodes:
            return
        nodes = np.zeros(max_nodes, dtype=np.int32)
        nodes[: self.max_nodes] = self.nodes
        self.alloc.free_chunk(self.max_nodes, max_nodes - self.max_nodes)
        self.alloc.max_nodes = self.max_nodes = max_nodes
        self.nodes = nodes

    def _alloc(self, n):
        """A span for ``n`` nodes and their free tail; a full pool
        doubles first."""
        while True:
            try:
                return self.alloc.alloc_chunk(n)
            except MemoryError:
                self.grow_pool(2 * self.max_nodes)

    # ------------------------------------------------------------ chunks

    def create_chunk(self, cpos, chunk_nodes):
        """Install chunk data received from the server (world.rs:310-335).

        Raises PosOutOfBounds for out-of-window chunks (callers treat that
        as a benign late delivery, client/src/lib.rs:116).
        """
        cpos = tuple(int(v) for v in cpos)
        if not self.in_window(cpos):
            raise PosOutOfBounds()
        chunk_nodes = np.asarray(chunk_nodes)
        n = len(chunk_nodes)
        old = self.chunks.pop(cpos, None)
        if old is not None and old.end - old.start >= n + 1:
            start, end = old.start, old.end
        else:
            if old is not None:
                self.alloc.free_chunk(old.start, old.end - old.start)
            start, end = self._alloc(n)
        self.nodes[start : start + n] = chunk_nodes.astype(np.int32)
        chunk = Chunk(start, end, n)
        self.chunks[cpos] = chunk
        return chunk

    def free_chunk(self, cpos):
        chunk = self.chunks.pop(tuple(int(v) for v in cpos), None)
        if chunk is not None:
            self.alloc.free_chunk(chunk.start, chunk.end - chunk.start)

    def _chunk_at_voxel(self, pos):
        p = np.asarray(pos, np.int64)
        cpos = tuple(int(v) for v in np.floor_divide(p, CHUNK_SIZE))
        chunk = self.chunks.get(cpos)
        if chunk is None:
            if not self.in_window(cpos):
                raise PosOutOfBounds()
            raise NoChunk()
        local = p - np.asarray(cpos, np.int64) * CHUNK_SIZE
        return chunk, local

    def get_voxel(self, pos):
        chunk, local = self._chunk_at_voxel(pos)
        view = self.nodes[chunk.start : chunk.end]
        if chunk.native:
            return native.get_voxel(view, local)
        node = Svo(0, CHUNK_SIZE).find_node(view, local.astype(np.float32))
        return nodefmt.voxel_of(int(view[node.idx]))

    def set_voxel(self, pos, voxel):
        """In-place SVO edit; grows the chunk's span on OutOfMemory."""
        chunk, local = self._chunk_at_voxel(pos)
        for _ in range(2):
            view = self.nodes[chunk.start : chunk.end]
            try:
                if chunk.native:
                    if not native.set_node(view, chunk.alloc, local, voxel):
                        raise OutOfMemory()
                else:
                    Svo(0, CHUNK_SIZE).set_node(
                        view, local.astype(np.float32), voxel, CHUNK_DEPTH,
                        chunk.alloc,
                    )
                return chunk
            except OutOfMemory:
                chunk = self._grow_chunk(pos, chunk)
        raise OutOfMemory()

    def _grow_chunk(self, pos, chunk):
        p = np.asarray(pos, np.int64)
        cpos = tuple(int(v) for v in np.floor_divide(p, CHUNK_SIZE))
        used = chunk.alloc.last_used_addr + 1
        old_len = chunk.end - chunk.start
        data = self.nodes[chunk.start : chunk.start + used].copy()
        self.chunks.pop(cpos)
        self.alloc.free_chunk(chunk.start, old_len)
        start, end = self._alloc(used + CHUNK_INIT_FREE_MEM)
        self.nodes[start : start + used] = data
        # Fresh tail allocator: free holes inside the used prefix are
        # abandoned until the next full chunk rebuild replaces the span.
        grown = Chunk(start, end, used)
        self.chunks[cpos] = grown
        return grown

    def highest_voxel_at(self, x, z):
        """Topmost non-air voxel in the window column (world.rs:344-366)."""
        top = (self.min_chunk[1] + self.size_in_chunks) * CHUNK_SIZE - 1
        bottom = self.min_chunk[1] * CHUNK_SIZE
        for y in range(int(top), int(bottom) - 1, -1):
            try:
                if self.get_voxel((x, y, z)) != 0:
                    return y
            except (NoChunk, PosOutOfBounds):
                continue
        return None

    # ------------------------------------------------------------ physics

    def get_collisions_w(self, region: Aabb, voxels):
        """Solid-voxel AABBs overlapping ``region`` (world.rs:368-392);
        solidity comes from the voxel pack."""
        lo = np.floor(region.from_).astype(np.int64) - 1
        hi = np.floor(region.to).astype(np.int64) + 1
        out = []
        for x in range(lo[0], hi[0] + 1):
            for y in range(lo[1], hi[1] + 1):
                for z in range(lo[2], hi[2] + 1):
                    try:
                        v = self.get_voxel((x, y, z))
                    except (NoChunk, PosOutOfBounds):
                        continue
                    data = voxels.get(v)
                    if data is not None and data.is_solid:
                        box = Aabb((x, y, z), (x + 1, y + 1, z + 1))
                        if box.intersects(region):
                            out.append(box)
        return out
