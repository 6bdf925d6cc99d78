# Frozen copy of voxelraytracing_tpu_torch/worldgen/terrain.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Imports adjusted.

"""Batched terrain generation on the device.

Port of ``voxelraytracing_tpu/worldgen/terrain.py``. A whole batch of
chunks is one pass of torch ops on the generator's device (the card unless
the caller asks for the CPU): noise fields evaluate as ``[B, 32, 32]``
maps, the biome comes from a gather on the 8×20 lookup table
(gen.rs:152-165), biome layer stacks fill columns via a gather on a padded
per-biome layer table (gen.rs:204-226), sea-level water fills the
remainder (gen.rs:227-236), and vegetation peaks fall out of an
8-neighbor strict-maximum test on a halo-extended feature-noise map
(gen.rs:242-261). The JAX module computes all of this with XLA, outside
any Pallas kernel; these torch ops are its port. The dense grids then
feed ``ops/svo_build.build_chunk_svo_batch``.
"""

import numpy as np
import torch

CHUNK_SIZE = 32  # core/constants.py
from . import noise
from .packs import WorldPresetCfg
from .fields import CompiledMap, SeedChain, ValueField


class TerrainGen:
    """Compiled preset: value fields + biome/layer tables on ``device``."""

    def __init__(self, preset: WorldPresetCfg, seed, device="cuda"):
        chain = SeedChain(seed)
        self.preset = preset
        self.seed = int(seed)
        self.device = torch.device(device)
        # Declaration order fixes the seed chain (gen.rs:96-122).
        self.height = ValueField(preset.height, chain)
        self.temp = ValueField(preset.temp, chain)
        self.humidity = ValueField(preset.humidity, chain)
        self.weirdness = ValueField(preset.weirdness, chain)
        self.vegetation_perm = noise.make_permutation(chain.next())
        self.feat_map = CompiledMap(
            perm=noise.make_permutation(chain.next()), freq=0.15, scale=1.0,
            offset=0.0,
        )

        self.sea_level = int(preset.sea_level)
        self.earth = int(preset.earth)
        self.water = int(preset.water)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self.biome_lookup = dev(np.asarray(preset.biome_lookup, np.int64))

        n_biomes = len(preset.biomes)
        max_layers = max((len(b.layers) for b in preset.biomes), default=0) or 1
        layers = np.full((n_biomes, max_layers), self.earth, dtype=np.int32)
        layer_len = np.zeros(n_biomes, dtype=np.int32)
        veg = np.zeros((n_biomes, 3), dtype=np.float32)
        for i, b in enumerate(preset.biomes):
            layer_len[i] = len(b.layers)
            layers[i, : len(b.layers)] = b.layers
            veg[i] = (b.vegetation.freq, b.vegetation.scale, b.vegetation.offset)
        self.layer_table = dev(layers)
        self.layer_len = dev(layer_len)
        self.veg_params = dev(veg)

    def _pos(self, pos2d):
        return torch.as_tensor(pos2d, dtype=torch.float32, device=self.device)

    # -------------------------------------------------- field evaluation

    def biome_index(self, pos2d):
        """Biome id (int64) for world-space (x, z) samples (gen.rs:152-165)."""
        pos2d = self._pos(pos2d)
        temp = self.temp(pos2d)
        humidity = self.humidity(pos2d)
        weird = self.weirdness(pos2d)
        i32 = torch.int32
        temp_idx = torch.clamp(torch.floor(temp * 20.0).to(i32), 0, 19)
        weird_idx = torch.clamp(torch.round(weird).to(i32), 0, 1) * 4
        hum_idx = torch.clamp(torch.floor(humidity * 4.0).to(i32), 0, 3)
        return self.biome_lookup[(hum_idx + weird_idx).long(), temp_idx.long()]

    def terrain_height(self, pos2d):
        """Surface height as int32 (truncation like the reference's
        ``as i32``, gen.rs:125-127)."""
        return self.height(self._pos(pos2d)).to(torch.int32)

    # -------------------------------------------------- chunk batch

    def generate_grids(self, chunk_positions):
        """``int[B, 3]`` chunk coords -> dense voxel grids ``int32[B, 32
        (x), 32 (y), 32 (z)]`` and the aux maps ``height``, ``biome``,
        ``peak``, ``veg_prob`` (``[B, 32 (x), 32 (z)]``), on the device.
        The reference's buried-chunk single-node shortcut (gen.rs:179-202)
        is unnecessary: uniform grids collapse to one node in the SVO
        build."""
        cs = CHUNK_SIZE
        dev = self.device
        f32, i32 = torch.float32, torch.int32
        chunk_pos = torch.as_tensor(
            np.asarray(chunk_positions, np.int64).reshape(-1, 3),
            device=dev).to(i32)
        corner = chunk_pos * cs  # [B, 3] voxel-space min corner

        lx = torch.arange(cs, dtype=i32, device=dev)
        gx = corner[:, 0, None] + lx  # [B, 32]
        gz = corner[:, 2, None] + lx
        # [B, 32(x), 32(z), 2] world-space column positions
        pos2d = torch.stack(torch.broadcast_tensors(
            gx[:, :, None].to(f32), gz[:, None, :].to(f32)), dim=-1)

        h = self.terrain_height(pos2d)  # [B, 32, 32]
        biome = self.biome_index(pos2d)  # [B, 32, 32]

        # Column fill: voxel at depth `layer = h - y` comes from the biome's
        # layer stack, or `earth` below the stack (gen.rs:204-226).
        gy = corner[:, 1, None] + lx  # [B, 32]
        y = gy[:, None, :, None]  # [B, 1, 32(y), 1]
        hh = h[:, :, None, :]  # [B, 32(x), 1, 32(z)]
        bio = biome[:, :, None, :]  # [B, 32, 1, 32]

        layer = hh - y  # depth below surface
        max_l = self.layer_table.shape[1]
        lv = self.layer_table[bio, torch.clamp(layer, 0, max_l - 1).long()]
        lv = torch.where(layer >= self.layer_len[bio], self.earth, lv)
        grid = torch.where(layer >= 0, lv, 0)

        # Sea-level water above the surface (gen.rs:227-236).
        grid = torch.where((layer < 0) & (y < self.sea_level), self.water,
                           grid)

        # Vegetation: feature-noise strict local peaks (gen.rs:242-261) at
        # columns whose surface lies inside this chunk and at/above sea
        # level. The halo: one column more on each side, at +-1.0.
        one_x = torch.tensor([1.0, 0.0], device=dev)
        one_z = torch.tensor([0.0, 1.0], device=dev)
        hx = torch.cat([pos2d[:, :1] - one_x, pos2d, pos2d[:, -1:] + one_x],
                       dim=1)
        hxz = torch.cat([hx[:, :, :1] - one_z, hx, hx[:, :, -1:] + one_z],
                        dim=2)  # [B, 34, 34, 2]
        feat = self.feat_map.sample(hxz)  # [B, 34, 34]
        c = feat[:, 1:-1, 1:-1]
        neigh = torch.stack([
            feat[:, 0:-2, 0:-2], feat[:, 0:-2, 1:-1], feat[:, 0:-2, 2:],
            feat[:, 1:-1, 0:-2],                       feat[:, 1:-1, 2:],
            feat[:, 2:, 0:-2],   feat[:, 2:, 1:-1],   feat[:, 2:, 2:],
        ], dim=-1)
        is_peak = (c[..., None] > neigh).all(dim=-1)

        surf_local = h - corner[:, 1, None, None]  # h - chunk_y0
        in_chunk = (surf_local >= 0) & (surf_local < cs)
        peak = is_peak & in_chunk & (h >= self.sea_level)

        # Per-column vegetation probability (biome Map over world coords;
        # the reference samples chunk-local coords here, gen.rs:263-268 —
        # a repeating-pattern quirk the JAX package does not reproduce).
        vp = self.veg_params[biome]  # [B, 32, 32, 3]
        veg_prob = (noise.sample01(self.vegetation_perm, pos2d * vp[..., 0:1])
                    * vp[..., 1] + vp[..., 2])

        return grid.to(i32), {
            "height": h,
            "biome": biome.to(i32),
            "peak": peak,
            "veg_prob": veg_prob,
        }

    # -------------------------------------------------- spawn search

    def find_land_near(self, x, z):
        """First sampled land column at/above sea level on a coarse lattice
        around (x, z) (gen.rs:123-150). Returns (x, h, z) or None."""
        gap, steps = 10, 100
        for xs0, zs0 in ((x, z), (x - steps, z - steps)):
            xs = (np.arange(xs0, xs0 + steps) * gap).astype(np.float32)
            zs = (np.arange(zs0, zs0 + steps) * gap).astype(np.float32)
            pos = np.stack(np.meshgrid(xs, zs, indexing="ij"), axis=-1)
            h = self.terrain_height(pos).cpu().numpy()
            hits = np.argwhere(h > self.sea_level)
            if len(hits):
                i, j = hits[0]
                return int(pos[i, j, 0]), int(h[i, j]), int(pos[i, j, 1])
        return None
