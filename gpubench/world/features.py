# Frozen copy of voxelraytracing_tpu_torch/worldgen/features.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Imports adjusted.

"""Procedural feature building (trees, spikes, lakes, ...).

Feature instances are tiny voxel clouds (tens to a few thousand voxels), so
they build on the host with NumPy and stamp into chunks as scatter lists —
per SURVEY §7 the latency-sensitive small stuff belongs host-side, the dense
per-chunk tensors on device. Shapes follow the reference's six feature kinds
(server/src/world/gen.rs:289-487): Tree (trunk line + leaf spheres + random
hemisphere branches), CanopyTree (flat canopy discs), Evergreen (stacked
shrinking discs), Cactus (with side splits), Spike (tapered discs), Lake
(buried liquid discs with an air carve above).

Unlike the reference's global ``fastrand`` state (nondeterministic across
runs), every feature draws from an rng seeded by (world seed, surface pos),
so generated worlds are fully reproducible — the property the engine's
regenerate-if-missing recovery depends on (SURVEY §5 checkpoint/resume).

Port of ``voxelraytracing_tpu/worldgen/features.py`` (host NumPy,
unchanged).
"""

import numpy as np

from .geometry import rand_cardinal_dir, rand_hem_dir, walk_line
from .packs import FeatureCfg


class BuiltFeature:
    """A placed feature: ``{(x,y,z): voxel}`` cloud + inclusive AABB bounds."""

    __slots__ = ("voxels", "min", "max")

    def __init__(self):
        self.voxels = {}
        self.min = np.array([2**31 - 1] * 3, dtype=np.int64)
        self.max = np.array([-(2**31)] * 3, dtype=np.int64)

    def set_voxel(self, pos, v):
        pos = (int(pos[0]), int(pos[1]), int(pos[2]))
        self.voxels[pos] = int(v)
        p = np.asarray(pos, dtype=np.int64)
        self.min = np.minimum(self.min, p)
        self.max = np.maximum(self.max, p)

    def place_line(self, start, end, v):
        for pos in walk_line(start, end):
            self.set_voxel(pos, v)

    def _fill_by_radius(self, center, r, lo, hi, v):
        xs = np.arange(lo[0], hi[0] + 1)
        ys = np.arange(lo[1], hi[1] + 1)
        zs = np.arange(lo[2], hi[2] + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        bc = np.stack([gx, gy, gz], axis=-1) + 0.5
        d2 = np.sum((bc - np.asarray(center)) ** 2, axis=-1)
        for p in np.argwhere(d2 < r * r):
            self.set_voxel((xs[p[0]], ys[p[1]], zs[p[2]]), v)

    def place_sphere(self, center, r, v):
        c = np.asarray(center, dtype=np.int64)
        self._fill_by_radius(c + 0.5, r, c - int(r), c + int(r), v)

    def place_disc(self, center, r, height, v):
        c = np.asarray(center, dtype=np.int64)
        lo = c - np.array([int(r), 0, int(r)])
        hi = c + np.array([int(r), int(height) - 1, int(r)])
        self._fill_by_radius(c + 0.5, r, lo, hi, v)

    def scatter_arrays(self):
        """(positions int64[N,3], voxels int32[N]) for device stamping."""
        if not self.voxels:
            return np.zeros((0, 3), np.int64), np.zeros(0, np.int32)
        pos = np.array(list(self.voxels.keys()), dtype=np.int64)
        vox = np.array(list(self.voxels.values()), dtype=np.int32)
        return pos, vox


def _randint(rng, lo, hi):
    """Uniform in [lo, hi) with degenerate-range tolerance."""
    if hi <= lo:
        return int(lo)
    return int(rng.integers(lo, hi))


def build_feature(rng, surface, cfg: FeatureCfg):
    """Instantiate one feature rooted at the surface voxel ``surface``."""
    out = BuiltFeature()
    sx, sy, sz = (int(v) for v in surface)
    p = cfg.params

    if cfg.kind == "Tree":
        height = _randint(rng, *p["height"])
        top = (sx, sy + height, sz)
        branch_count = 0 if height <= 8 else _randint(rng, *p["branch_count"])
        out.place_sphere(top, 5.0, p["leaf_voxel"])
        for _ in range(branch_count):
            bh_lo, bh_hi = p["branch_height"]
            branch_h = int(rng.uniform(bh_lo, bh_hi) * height)
            branch_len = _randint(rng, *p["branch_len"])
            d = rand_hem_dir(rng, (0.0, 1.0, 0.0))
            start = np.array([sx, sy + branch_h, sz])
            end = (start + d * branch_len).astype(np.int64)
            out.place_sphere(end, 3.0, p["leaf_voxel"])
            out.place_line(start, end, p["branch_voxel"])
        out.place_line((sx, sy, sz), top, p["trunk_voxel"])

    elif cfg.kind == "CanopyTree":
        r = _randint(rng, 5, 11) - 0.1
        height = _randint(rng, *p["height"])
        top = (sx, sy + height, sz)
        out.place_line((sx, sy, sz), top, p["trunk_voxel"])
        out.place_disc(top, r, 1, p["leaf_voxel"])
        for _ in range(_randint(rng, 1, 4)):
            branch_h = _randint(rng, 4, max(height, 5))
            branch_len = _randint(rng, 3, 6)
            d = rand_hem_dir(rng, (0.0, 1.0, 0.0))
            start = np.array([sx, sy + branch_h, sz])
            end = (start + d * branch_len).astype(np.int64)
            out.place_line(start, end, p["trunk_voxel"])
            out.place_disc(end, 4.0, 1, p["leaf_voxel"])

    elif cfg.kind == "Evergreen":
        offset = _randint(rng, *p["bottom_branch"])
        height = offset + _randint(rng, *p["height"])
        y, r = height, 1
        while y > offset:
            out.place_disc((sx, sy + y, sz), r - 0.1, 1, p["leaf_voxel"])
            r += 1
            y -= 2
        out.place_line((sx, sy, sz), (sx, sy + height - 1, sz), p["trunk_voxel"])

    elif cfg.kind == "Cactus":
        base = (sx, sy + 1, sz)
        height = _randint(rng, *p["height"])
        splits = _randint(rng, 0, 4) if height > 3 else 0
        out.place_line(base, (sx, sy + 1 + height, sz), p["voxel"])
        for _ in range(splits):
            split_h = _randint(rng, 1, height)
            split_len = _randint(rng, 1, 4)
            d = rand_cardinal_dir(rng)
            elbow = np.array(base) + np.array([0, split_h, 0]) + d
            out.set_voxel(elbow, p["voxel"])
            lo = np.array(base) + np.array([0, split_h, 0]) + d * 2
            out.place_line(lo, lo + np.array([0, split_len, 0]), p["voxel"])

    elif cfg.kind == "Spike":
        height = _randint(rng, *p["height"])
        width = _randint(rng, *p["width"])
        for y in range(height):
            delta = 1.0 - y / height
            w = np.floor(delta * width)
            out.place_disc((sx, sy + y, sz), w * 0.5 - 0.1, 1, p["voxel"])

    elif cfg.kind == "Lake":
        size = _randint(rng, *p["size"])
        depth = _randint(rng, *p["depth"])
        r = size * 0.5 - 0.1
        bury = 3
        for y in range(depth):
            out.place_disc((sx, sy - y - bury, sz), r - y * 0.5, 1, p["voxel"])
        for y in range(-2, bury):
            out.place_disc((sx, sy - y, sz), r, 1, 0)

    else:
        raise ValueError(cfg.kind)

    return out


def feature_rng(world_seed, surface):
    """Deterministic per-feature rng keyed by world seed + surface voxel."""
    sx, sy, sz = (int(v) for v in surface)
    key = (world_seed * 1_000_003 + sx * 73_856_093 + sy * 19_349_663 + sz * 83_492_791)
    return np.random.default_rng(key & 0xFFFFFFFFFFFF)


def choose_features(gen, chunk_pos, aux_np, thin_rng=None):
    """Turn one chunk's peak map into built features.

    ``aux_np``: dict of NumPy ``[32,32]`` maps (height/biome/peak/veg_prob)
    for the chunk. Thinning follows the reference (gen.rs:263-279): a peak
    survives with probability ``veg_prob``, then one of the biome's feature
    names is chosen uniformly. Deterministic per (seed, surface).
    """
    from .terrain import CHUNK_SIZE

    out = []
    peaks = np.argwhere(aux_np["peak"])
    cx, cy, cz = (int(v) for v in chunk_pos)
    for x, z in peaks:
        h = int(aux_np["height"][x, z])
        surface = (cx * CHUNK_SIZE + int(x), h, cz * CHUNK_SIZE + int(z))
        rng = feature_rng(gen.seed, surface)
        prob = float(aux_np["veg_prob"][x, z])
        if rng.integers(0, 1001) >= prob * 1000.0:
            continue
        biome = gen.preset.biomes[int(aux_np["biome"][x, z])]
        if not biome.features:
            continue
        name = biome.features[rng.integers(0, len(biome.features))]
        cfg = gen_features_lookup(gen, name)
        out.append(build_feature(rng, surface, cfg))
    return out


def gen_features_lookup(gen, name):
    return gen.features[name]
