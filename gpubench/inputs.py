"""The benchmark's inputs, made from a configuration: the voxel world (the
terra pack's generator, frozen under ``world/``, on the device in large
batches, features stamped) and its materials.

Both sides receive the same chunk grids and materials: the program through
its own builders, the reference (:mod:`.reference`) as the raw volume of
pack ids (:func:`volume`).
"""

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .world.packs import Datapack, Stylepack
from .world.worldgen import WorldGen

ROOT = Path(__file__).resolve().parent.parent   # the checkout
CHUNK = 32
GEN_BATCH = 512       # chunks a generator pass takes


class World(NamedTuple):
    """A window of ``w``³ chunks: ``chunks`` uint8 [w³, 32, 32, 32] pack ids
    (x, y, z inside a chunk), chunk ``(i, j, k)`` of the window at ``(i * w
    + j) * w + k``; its least chunk and voxel; the land point the generator
    found near (0, 0); the materials of the pack."""

    chunks: np.ndarray
    w: int
    min_chunk: np.ndarray
    world_min: np.ndarray
    land: tuple
    materials: object
    n_features: int

    @property
    def v(self):
        return self.w * CHUNK

    def cells(self):
        """The window-local chunk coordinates, in the order of ``chunks``."""
        r = np.arange(self.w)
        i, j, k = np.meshgrid(r, r, r, indexing="ij")
        return np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)


def packs(cfg):
    base = ROOT / "respack"
    return (Datapack.load_from(base / "datapacks" / cfg["pack"]),
            Stylepack.load_from(base / "stylepacks" / cfg["pack"]))


def window_min(cfg, land):
    """The window's least chunk. ``"player"``: centred on the chunk of a
    player standing on the land point, as the client centres its window
    (client/world.py); ``"ground"``: from chunk height 0, centred on the
    land point across (benchmarks/run.py's preset window)."""
    x, h, z = land
    w = cfg["window_chunks"]
    if cfg["window"] == "player":
        eye = np.array([x, h + 1 + cfg["eye_height"], z], np.float64)
        return np.floor(eye / CHUNK).astype(np.int64) - w // 2
    if cfg["window"] == "ground":
        return np.array([x // CHUNK - w // 2, 0, z // CHUNK - w // 2], np.int64)
    raise ValueError(f"unknown window {cfg['window']!r}")


def make_world(cfg, device):
    """The configuration's world, generated on ``device``."""
    dp, sp = packs(cfg)
    gen = WorldGen.from_datapack(dp, cfg["world_seed"], cfg["preset"],
                                 device=device)
    land = gen.find_land_near(0, 0) or (0, 80, 0)
    w = cfg["window_chunks"]
    mn = window_min(cfg, land)
    r = np.arange(w)
    i, j, k = np.meshgrid(r, r, r, indexing="ij")
    pos = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1) + mn
    chunks = np.empty((len(pos), CHUNK, CHUNK, CHUNK), np.uint8)
    feats = []
    for b0 in range(0, len(pos), GEN_BATCH):
        grids, fb = gen.generate_chunks(pos[b0:b0 + GEN_BATCH])
        chunks[b0:b0 + len(fb)] = grids.to(torch.uint8).cpu().numpy()
        feats.extend(f for fl in fb for f in fl)
    # features overwrite the terrain where they reach into the window
    for f in feats:
        p, v = f.scatter_arrays()
        c = p // CHUNK - mn
        ok = np.all((c >= 0) & (c < w), axis=1)
        p, v, c = p[ok], v[ok], c[ok]
        n = (c[:, 0] * w + c[:, 1]) * w + c[:, 2]
        lo = p % CHUNK
        chunks[n, lo[:, 0], lo[:, 1], lo[:, 2]] = v
    mats = sp.material_table(dp.voxels)
    return World(chunks, w, mn, mn * CHUNK, tuple(int(a) for a in land), mats,
                 len(feats))


def volume(world, device):
    """uint8 [Vp, Vp, Vp] pack ids (x, y, z) of the window on ``device``, Vp
    the window's edge rounded up to 64 voxels (air past it)."""
    w = world.w
    t = torch.from_numpy(world.chunks).to(device).reshape(w, w, w, CHUNK, CHUNK, CHUNK)
    t = t.permute(0, 3, 1, 4, 2, 5).reshape(w * CHUNK, w * CHUNK, w * CHUNK)
    vp = -(-w * CHUNK // 64) * 64
    if vp != w * CHUNK:
        pad = vp - w * CHUNK
        t = torch.nn.functional.pad(t, (0, pad, 0, pad, 0, pad))
    return t.contiguous()


def top_solid(world, x, z):
    """The height of the highest voxel that is not air in column ``(x, z)``
    (world voxels), or the window's floor."""
    cx, cz = x // CHUNK - world.min_chunk[0], z // CHUNK - world.min_chunk[2]
    w = world.w
    col = world.chunks.reshape(w, w, w, CHUNK, CHUNK, CHUNK)[cx, :, cz, x % CHUNK, :, z % CHUNK]
    filled = np.nonzero(col.reshape(-1))[0]
    base = int(world.min_chunk[1]) * CHUNK
    return base + (int(filled[-1]) if filled.size else 0)
