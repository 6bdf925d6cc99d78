# Frozen copy of voxelraytracing_tpu_torch/worldgen/fields.py at commit 5046bbb1c27cf55a0e0985dd2724f80b90766057
# (the benchmark's yardstick: later changes to the program do not reach it).
# Imports adjusted.

"""Worldgen value fields: seeded, vectorized noise pipelines.

Port of ``voxelraytracing_tpu/worldgen/fields.py``: compiles a preset's
``Source`` configs (Value / Noise / ComplexNoise) into batched torch
evaluators over ``f32[..., 2]`` sample positions, on the positions'
device — the tensorized equivalent of the reference's per-column
``ValueGen::eval`` (server/src/world/gen.rs:14-47). Seeds for each noise
map are derived from the running world seed with the same wrapping-i64
mix chain, in the same declaration order (gen.rs:48-55, 96-122), so a
preset + seed fully determines the world.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import noise
from .packs import MapCfg, SourceCfg


@dataclass(frozen=True)
class CompiledMap:
    """A seeded MappedNoise: sample01(pos * freq) * scale + offset."""

    perm: np.ndarray
    freq: float
    scale: float
    offset: float

    @classmethod
    def from_cfg(cls, cfg: MapCfg, seed_chain):
        return cls(
            perm=noise.make_permutation(seed_chain.next()),
            freq=cfg.freq,
            scale=cfg.scale,
            offset=cfg.offset,
        )

    def sample(self, pos):
        pos = torch.as_tensor(pos, dtype=torch.float32)
        return (noise.sample01(self.perm, pos * self.freq) * self.scale
                + self.offset)


class SeedChain:
    """Stateful wrapper over :func:`noise.transmute_seed`."""

    def __init__(self, seed):
        self.seed = int(seed)

    def next(self):
        self.seed, derived = noise.transmute_seed(self.seed)
        return derived


class ValueField:
    """A compiled Source: callable ``f32[..., 2] -> f32[...]``."""

    def __init__(self, cfg: SourceCfg, seed_chain: SeedChain):
        self.kind = cfg.kind
        if cfg.kind == "value":
            self.value = float(cfg.value)
        elif cfg.kind == "noise":
            self.noise = CompiledMap.from_cfg(cfg.noise, seed_chain)
        elif cfg.kind == "complex":
            self.freq = CompiledMap.from_cfg(cfg.freq, seed_chain)
            self.scale = CompiledMap.from_cfg(cfg.scale, seed_chain)
            self.base = CompiledMap.from_cfg(cfg.base, seed_chain)
            self.layers = tuple(
                CompiledMap.from_cfg(m, seed_chain) for m in cfg.layers
            )
        else:
            raise ValueError(cfg.kind)

    def __call__(self, pos):
        pos = torch.as_tensor(pos, dtype=torch.float32)
        if self.kind == "value":
            return torch.full(pos.shape[:-1], self.value,
                              dtype=torch.float32, device=pos.device)
        if self.kind == "noise":
            return self.noise.sample(pos)
        freq = self.freq.sample(pos)
        scale = self.scale.sample(pos)
        out = self.base.sample(pos * freq[..., None]) * scale
        for layer in self.layers:
            out = out + layer.sample(pos)
        return out
