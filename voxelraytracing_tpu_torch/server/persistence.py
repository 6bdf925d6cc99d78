"""World persistence: region files.

Port of ``voxelraytracing_tpu/server/persistence.py``, byte for byte on
disk: either package reads the other's region files.

One file per 16³-chunk region, ``regions/r_{x}_{y}_{z}_.data`` — a compact
header mapping chunk coords to node ranges followed by the raw ``uint16``
SVO node data (the same shape as the reference's region format,
servercli/src/main.rs:25-75, but with an explicit JSON header instead of
bincode + unsafe transmutes). Saving merges dirty chunks over the existing
file contents; chunk reads go through a per-region cache
(servercli/src/main.rs:77-223). Chunks absent from disk fall through to
regeneration — worldgen is a pure function of (seed, pos), so the region
store is an *optimization*, not the source of truth (SURVEY §5
checkpoint/resume).
"""

import logging
import json
import os
import struct
import threading

import numpy as np

from ..core.constants import REGION_SIZE

# a plain module logger: importing configures no handler (entry points
# call utils.log.init_logging)
log = logging.getLogger(__name__)

_MAGIC = b"VXRG1\n"


def region_of(cpos):
    return tuple(int(v) // REGION_SIZE for v in cpos)


def region_path(root, rpos):
    return os.path.join(root, "regions", f"r_{rpos[0]}_{rpos[1]}_{rpos[2]}_.data")


def write_region(path, chunks):
    """``chunks``: {(cx,cy,cz): uint16 nodes}. Atomic replace."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = {}
    blobs = []
    off = 0
    for cpos, nodes in chunks.items():
        nodes = np.asarray(nodes, dtype="<u2")
        header[",".join(str(v) for v in cpos)] = [off, len(nodes)]
        blobs.append(nodes.tobytes())
        off += len(nodes)
    head = json.dumps(header).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def read_region(path):
    """-> {(cx,cy,cz): uint16 nodes} or {} if absent."""
    if not os.path.isfile(path):
        return {}
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"bad region file {path}")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        body = f.read()
    data = np.frombuffer(body, dtype="<u2")
    out = {}
    for key, (off, n) in header.items():
        cpos = tuple(int(v) for v in key.split(","))
        out[cpos] = data[off : off + n].copy()
    return out


class WorldFs:
    """Filesystem-backed chunk store with a region cache and dirty tracking
    (the reference's ``WorldFs``, servercli/src/main.rs:77-223)."""

    def __init__(self, world_dir):
        self.root = world_dir
        self._lock = threading.RLock()
        self._cache = {}  # rpos -> {cpos: nodes}
        self._dirty = set()  # chunk positions needing save
        self.available_chunks = set()
        self._scan()

    def _scan(self):
        """Index every chunk present on disk (headers only would suffice;
        region files are small, so loading is fine)."""
        rdir = os.path.join(self.root, "regions")
        if not os.path.isdir(rdir):
            return
        for name in os.listdir(rdir):
            if not (name.startswith("r_") and name.endswith("_.data")):
                continue
            try:
                parts = name[2:-6].split("_")
                rpos = tuple(int(v) for v in parts[:3])
            except ValueError:
                continue
            chunks = read_region(region_path(self.root, rpos))
            self._cache[rpos] = chunks
            self.available_chunks.update(chunks.keys())

    def read_chunk(self, cpos):
        cpos = tuple(int(v) for v in cpos)
        with self._lock:
            if cpos not in self.available_chunks:
                return None
            rpos = region_of(cpos)
            region = self._cache.get(rpos)
            if region is None:
                region = read_region(region_path(self.root, rpos))
                self._cache[rpos] = region
            return region.get(cpos)

    def add_dirty_chunk(self, cpos):
        with self._lock:
            self._dirty.add(tuple(int(v) for v in cpos))

    def save(self, world):
        """Merge dirty chunks into their region files (read-merge-rewrite,
        servercli/src/main.rs:106-133). ``world`` supplies node data via
        ``build_nodes``."""
        with self._lock:
            dirty = list(self._dirty)
            self._dirty.clear()
        if not dirty:
            return 0
        nodes_by_pos = world.build_nodes(dirty)
        by_region = {}
        for cpos, nodes in nodes_by_pos.items():
            if nodes is None:
                continue
            by_region.setdefault(region_of(cpos), {})[cpos] = nodes
        with self._lock:
            for rpos, chunks in by_region.items():
                path = region_path(self.root, rpos)
                merged = self._cache.get(rpos)
                if merged is None:
                    merged = read_region(path)
                merged.update(chunks)
                self._cache[rpos] = merged
                write_region(path, merged)
                self.available_chunks.update(chunks.keys())
        n = sum(len(c) for c in by_region.values())
        log.info("saved %d chunks across %d regions", n, len(by_region))
        return n

    def dirty_count(self):
        with self._lock:
            return len(self._dirty)
