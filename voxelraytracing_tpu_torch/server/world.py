"""Server-side world authority.

Port of ``voxelraytracing_tpu/server/world.py``, the redesign of the
reference's ``ServerWorld``/``ServerChunk`` (server/src/world/mod.rs): the
*mutable source of truth* is a dense ``uint16[32³]`` grid per chunk (cheap
host mutation, no allocator), and the SVO form is **rebuilt functionally
in device batches** (``ops/svo_build.py``, on the generator's device)
whenever chunks need serializing — the reference instead mutates pooled
SVO nodes through a free-list allocator per edit. Deferred feature
placement keeps the reference's rule: a feature's voxels are only written
once every chunk its bounds touch exists (server/src/world/mod.rs:28-55).
``fs`` is anything with ``read_chunk(pos) -> uint16 nodes or None``.
"""

import numpy as np

from ..core.constants import CHUNK_SIZE


class ServerChunk:
    """Dense voxel grid + lazily rebuilt SVO node cache."""

    __slots__ = ("grid", "nodes", "dirty")

    def __init__(self, grid, nodes=None):
        self.grid = np.asarray(grid, dtype=np.uint16)
        self.nodes = None if nodes is None else np.asarray(nodes, np.uint16)
        self.dirty = False

    def set_voxel(self, local, voxel):
        self.grid[tuple(int(v) for v in local)] = voxel
        self.nodes = None  # invalidate SVO cache

    def get_voxel(self, local):
        return int(self.grid[tuple(int(v) for v in local)])


class ServerWorld:
    """Chunk map + deferred feature placement (server/src/world/mod.rs:14-80)."""

    def __init__(self, gen):
        self.gen = gen
        self.chunks = {}  # (cx,cy,cz) -> ServerChunk
        self.unplaced_features = []

    # ------------------------------------------------------------ chunks

    def get_chunk(self, cpos):
        return self.chunks.get(tuple(int(v) for v in cpos))

    def insert_chunk(self, cpos, chunk: ServerChunk):
        self.chunks[tuple(int(v) for v in cpos)] = chunk

    def set_voxel(self, pos, voxel):
        """Write one voxel; returns the touched chunk pos or None."""
        p = np.asarray(pos, np.int64)
        cpos = tuple(int(v) for v in np.floor_divide(p, CHUNK_SIZE))
        chunk = self.chunks.get(cpos)
        if chunk is None:
            return None
        local = p - np.asarray(cpos, np.int64) * CHUNK_SIZE
        chunk.set_voxel(local, voxel)
        chunk.dirty = True
        return cpos

    def get_voxel(self, pos):
        p = np.asarray(pos, np.int64)
        cpos = tuple(int(v) for v in np.floor_divide(p, CHUNK_SIZE))
        chunk = self.chunks.get(cpos)
        if chunk is None:
            return None
        return chunk.get_voxel(p - np.asarray(cpos, np.int64) * CHUNK_SIZE)

    # ------------------------------------------------------------ features

    def add_features(self, features):
        self.unplaced_features.extend(features)

    def place_features(self):
        """Stamp every feature whose spanned chunks all exist; returns the
        set of chunk positions touched (server/src/world/mod.rs:28-55)."""
        touched = set()
        still_pending = []
        for feat in self.unplaced_features:
            lo = np.floor_divide(feat.min, CHUNK_SIZE)
            hi = np.floor_divide(feat.max, CHUNK_SIZE)
            spanned = [
                (x, y, z)
                for x in range(int(lo[0]), int(hi[0]) + 1)
                for y in range(int(lo[1]), int(hi[1]) + 1)
                for z in range(int(lo[2]), int(hi[2]) + 1)
            ]
            if not all(c in self.chunks for c in spanned):
                still_pending.append(feat)
                continue
            for vpos, vox in feat.voxels.items():
                c = self.set_voxel(vpos, vox)
                if c is not None:
                    touched.add(c)
        self.unplaced_features = still_pending
        return touched

    # ------------------------------------------------------------ SVO build

    def build_nodes(self, positions):
        """(Re)build trimmed SVO node arrays for ``positions`` in one device
        batch (on the generator's device); results cached on the chunks.
        The batch dimension stands for the reference's 16-thread builder
        pool (SURVEY §2.7 P2)."""
        from ..ops.svo_build import build_chunk_svo_batch

        todo = [
            p for p in positions
            if p in self.chunks and self.chunks[p].nodes is None
        ]
        if todo:
            grids = np.stack([self.chunks[p].grid.astype(np.int32) for p in todo])
            nodes, counts = build_chunk_svo_batch(grids, device=self.gen.device)
            nodes = nodes.cpu().numpy()
            counts = counts.cpu().numpy()
            for i, p in enumerate(todo):
                self.chunks[p].nodes = nodes[i, : int(counts[i])].astype(np.uint16)
        return {p: self.chunks[p].nodes for p in positions if p in self.chunks}

    def generate_chunks(self, positions, fs=None):
        """Load-or-generate a batch of chunks (the ChunkBuilder analog,
        server/src/lib.rs:67-100): persisted chunks come from ``fs``, the
        rest generate on device in one batch; freshly generated chunks
        contribute their features to the deferred queue."""
        positions = [tuple(int(v) for v in p) for p in positions]
        missing = [p for p in positions if p not in self.chunks]
        from_disk = []
        if fs is not None:
            from ..core import native

            for p in list(missing):
                nodes = fs.read_chunk(p)
                if nodes is not None:
                    if native.available():
                        grid = native.svo_to_dense(nodes.astype(np.int32))
                    else:
                        from ..core.svo import svo_to_dense

                        grid = svo_to_dense(nodes.astype(np.int32))
                    self.insert_chunk(p, ServerChunk(grid, nodes))
                    from_disk.append(p)
                    missing.remove(p)
        if missing:
            grids, feats = self.gen.generate_chunks(
                np.asarray(missing), as_u8=True
            )
            grids = grids.cpu().numpy()
            for i, p in enumerate(missing):
                self.insert_chunk(p, ServerChunk(grids[i]))
            for fl in feats:
                self.add_features(fl)
        return from_disk + missing
