"""Shared tracer constants and render-id maps.

Port of the pieces of ``voxelraytracing_tpu/ops/wavefront.py`` that the
bit-plane tracers build on. The v1 tracer itself and its brick tables are
not ported: the v3/v4 builders need only the render-id maps.

Render ids are a state-sorted remap of pack voxel ids (0 = air, then
liquids, then everything else), so liquid tests are range compares instead
of material-table gathers.
"""

from typing import NamedTuple

import numpy as np
import torch

TILE_W, TILE_H = 16, 8  # 128 rays per tile
BRICK = 4  # voxels per brick side
EPS_T = 1e-3  # ray-space nudge across cell boundaries (the 0.001 of
#               ray_tracer.wgsl:274-283, applied along t)
_BIG = 1e9  # masked-out sentinel for the DDA of axis-parallel rays
# Inverse-direction cap: directions with |c| < 1e-7 count as axis-degenerate
# (they advance < 1e-4 voxels across any representable world), so legit
# inverses stay <= 1e7 and DDA products <= 64 x 1e7 << _BIG.
_BIG_IV = 1e7


def render_id_maps(is_liquid_np):
    """Sort pack ids into render ids: 0=air, 1..L=liquids, rest solid.

    Args:
      is_liquid_np: bool array over pack voxel ids (index 0 must be air).
    Returns:
      (to_render int32[n_pack], to_pack int32[256], n_liquid int)
    """
    n = len(is_liquid_np)
    liquids = [i for i in range(1, n) if is_liquid_np[i]]
    others = [i for i in range(1, n) if not is_liquid_np[i]]
    order = [0] + liquids + others  # render id -> pack id
    if len(order) > 256:
        raise ValueError("wavefront tracer supports at most 256 voxel types")
    to_pack = np.zeros(256, np.int32)
    to_pack[: len(order)] = order
    to_render = np.zeros(n, np.int32)
    for rid, pid in enumerate(order):
        to_render[pid] = rid
    return to_render, to_pack, len(liquids)


def _cdiv(a, b):
    return -(-a // b)


class WavefrontResult(NamedTuple):
    hit: torch.Tensor  # bool[H, W]
    voxel: torch.Tensor  # int32[H, W] — pack voxel id at hit
    norm: torch.Tensor  # f32[H, W, 3]
    t: torch.Tensor  # f32[H, W] — hit distance
    water_dist: torch.Tensor  # f32[H, W]
    steps: torch.Tensor  # int32[H, W]
