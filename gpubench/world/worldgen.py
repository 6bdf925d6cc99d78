# Frozen copy of voxelraytracing_tpu_torch/worldgen/__init__.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Imports adjusted; the module is worldgen.py here.

"""Worldgen: data-driven procedural chunk generation on the device.

Port of ``voxelraytracing_tpu/worldgen``. ``WorldGen`` ties the pieces
together: a compiled preset (noise fields + biome tables, ``terrain.py``)
generates dense voxel grids for a *batch* of chunks in one pass of torch
ops on its device (the card unless the caller asks for the CPU);
vegetation peaks come back as maps and become host-built feature voxel
clouds (``features.py``). The equivalent of the reference's ``WorldGen``
+ chunk-builder thread pool (server/src/world/gen.rs,
server/src/lib.rs:67-100): the 16-thread × 128-chunk fan-out becomes the
batch dimension.
"""

import numpy as np
import torch

from .packs import Datapack, WorldPresetCfg
from .features import BuiltFeature, build_feature, choose_features
from .terrain import TerrainGen

__all__ = ["WorldGen", "BuiltFeature", "TerrainGen", "build_feature"]


class WorldGen:
    """Seeded, preset-driven chunk generator on ``device``."""

    def __init__(self, preset: WorldPresetCfg, features: dict, seed: int,
                 device="cuda"):
        self.terrain = TerrainGen(preset, seed, device=device)
        self.features = dict(features)
        self.preset = preset
        self.seed = int(seed)
        self.device = self.terrain.device

    @classmethod
    def from_datapack(cls, pack: Datapack, seed, preset_name=None,
                      device="cuda"):
        presets = pack.world_presets
        if preset_name is None:
            preset = presets[0]
        else:
            preset = next(p for p in presets if p.name == preset_name)
        return cls(preset, pack.world_features, seed, device=device)

    # Delegates used by server logic / tools.
    def terrain_h_at(self, x, z):
        h = self.terrain.terrain_height(np.asarray([[float(x), float(z)]],
                                                   np.float32))
        return int(h[0])

    def biome_at(self, x, z):
        idx = self.terrain.biome_index(np.asarray([[float(x), float(z)]],
                                                  np.float32))
        return self.preset.biomes[int(idx[0])]

    def find_land_near(self, x, z):
        return self.terrain.find_land_near(x, z)

    def max_voxel_id(self):
        """Largest voxel id the terrain pass can emit (layers + earth +
        water; features are stamped host-side later)."""
        ids = [self.preset.earth, self.preset.water, 0]
        for b in self.preset.biomes:
            ids.extend(b.layers)
        return max(int(v) for v in ids)

    def generate_chunks(self, chunk_positions, as_u8=False):
        """Generate a batch of chunks.

        Args:
          chunk_positions: int sequence/array ``[B, 3]`` of chunk coords.
          as_u8: cast the grids to ``uint8`` on the device before
            returning (4× fewer bytes for callers that copy them to the
            host: the streaming chunk builder). Only honored when every
            voxel id in the preset fits a byte.

        Returns:
          grids: ``int32[B, 32, 32, 32]`` tensor of dense voxel grids on the
            device (pre-feature), or ``uint8`` under ``as_u8``.
          features: list over batch of lists of :class:`BuiltFeature` —
            features rooted in each chunk (they may extend into neighbors;
            deferred placement is the server world's job).
        """
        chunk_positions = np.asarray(chunk_positions, np.int64).reshape(-1, 3)
        grids, aux = self.terrain.generate_grids(chunk_positions)
        if as_u8 and self.max_voxel_id() <= 0xFF:
            grids = grids.to(torch.uint8)
        aux_np = {k: v.cpu().numpy() for k, v in aux.items()}
        feats = []
        for i, cpos in enumerate(chunk_positions):
            per = {k: v[i] for k, v in aux_np.items()}
            feats.append(choose_features(self, cpos, per))
        return grids, feats
