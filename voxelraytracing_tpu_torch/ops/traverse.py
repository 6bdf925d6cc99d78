"""The traced-frame record the shader reads.

Of ``voxelraytracing_tpu/ops/traverse.py`` (the SVO reference tracer) the
port holds only :class:`TraceResult` so far: ``models/raytracer.py``'s
``shade_hits`` takes it.
"""

from typing import NamedTuple

import torch


class TraceResult(NamedTuple):
    hit: torch.Tensor  # bool[N]
    voxel: torch.Tensor  # int32[N] — voxel id at the hit (or last sampled)
    norm: torch.Tensor  # f32[N,3] — entry-face normal (0 if camera starts inside)
    pos: torch.Tensor  # f32[N,3] — world-local hit position
    water_dist: torch.Tensor  # f32[N] — distance traveled through liquid
    steps: torch.Tensor  # int32[N] — march iterations (debug heatmap)
