"""Shared tracer constants, render-id maps and the v1 brick-window world.

Port of the pieces of ``voxelraytracing_tpu/ops/wavefront.py`` that the
bit-plane tracers build on: the tile and brick constants, the render-id
maps, and the v1 :class:`RenderGrid` with its host builder
:func:`build_render_grid_host`, which the v2 march (``wavefront2.py``)
reads. The brick tables it builds are also the v3 grid's. The v1 tracer
itself (a host loop of XLA programs) is not ported.

Render ids are a state-sorted remap of pack voxel ids (0 = air, then
liquids, then everything else), so liquid tests are range compares instead
of material-table gathers.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import CHUNK_SIZE

TILE_W, TILE_H = 16, 8  # 128 rays per tile
BRICK = 4  # voxels per brick side
BWIN = 16  # bricks per brick-window side (64 voxels)
BWIN_VOX = BRICK * BWIN  # 64
N_SLOTS = 8  # brick-content slots per tile (8 x 16 words = one row)
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


def _i32(a, device):
    """NumPy integer words -> int32 tensor (a copy) with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a.astype(np.int32, copy=False), device=device)


class RenderGrid(NamedTuple):
    """The v1 brick-window world (bit words as int32, as everywhere in the
    port).

    bwin: ``[Nb³, 128]`` brick **descend** bits: set when a 4³ brick needs
      voxel-level resolution (any solid voxel, or air and liquid mixed).
      Window row ``wx + wy*Nb + wz*Nb²``; brick ``(bx,by,bz)`` of a window
      at linear ``bx + by*16 + bz*256`` -> word ``linear>>5``, bit
      ``linear&31``.
    lwin: ``[Nb³, 128]`` brick **all-liquid** bits, same layout.
    brick_dir: ``int32[S³]`` global brick id ``bx + by*S + bz*S²`` -> row in
      ``bricks`` (-1 where no chunk data); ``S`` = bricks per padded edge.
    bricks: ``[rows, 16]`` per-brick render ids, voxel ``(vx,vy,vz)`` at
      linear ``vx + vy*4 + vz*16`` -> word ``linear>>2``, byte ``linear&3``.
    world_min: ``int32[3]`` voxel coordinate of the world's min corner.
    to_pack: ``int32[256]`` render id -> pack voxel id.
    n_liquid: render ids 1..n_liquid are liquids.
    size_voxels: the real (unpadded) world edge in voxels.
    """

    bwin: torch.Tensor
    lwin: torch.Tensor
    brick_dir: torch.Tensor
    bricks: torch.Tensor
    world_min: torch.Tensor
    to_pack: torch.Tensor
    n_liquid: int
    size_voxels: int


def _brick_tables_np(grids, cells, w, to_render, vpad):
    """The v1 brick tables (ops/wavefront.py:build_render_grid_host
    :762-840): ``brick_dir`` int32[(vpad/4)³], the row of each 4³ brick
    of an installed chunk (-1 elsewhere), and ``bricks`` u32[B·512, 16],
    each row the brick's 64 render ids, four bytes a word."""
    b = grids.shape[0]
    rg = to_render[grids]
    valid = cells >= 0
    cx, cy, cz = cells % w, (cells // w) % w, cells // (w * w)
    bg_side = vpad // BRICK
    ii = np.arange(8)
    gbx = ii[None, :, None, None] + (cx * 8)[:, None, None, None]
    gby = ii[None, None, :, None] + (cy * 8)[:, None, None, None]
    gbz = ii[None, None, None, :] + (cz * 8)[:, None, None, None]
    gflat = (gbx + gby * bg_side + gbz * bg_side * bg_side).astype(np.int64)

    bview = rg.reshape(b, 8, BRICK, 8, BRICK, 8, BRICK)
    bc = bview.transpose(0, 1, 3, 5, 6, 4, 2).reshape(b * 512, 16, 4)
    bricks = (
        bc.astype(np.uint32) << (np.arange(4, dtype=np.uint32) * 8)
    ).sum(axis=-1, dtype=np.uint64).astype(np.uint32)

    li = (ii[:, None, None] * 64 + ii[None, :, None] * 8 + ii[None, None, :])
    rows = np.arange(b, dtype=np.int64)[:, None, None, None] * 512 + li[None]
    brick_dir = np.full(bg_side ** 3, -1, np.int32)
    ok = np.repeat(valid, 512)
    brick_dir[gflat.reshape(-1)[ok]] = rows.reshape(-1)[ok].astype(np.int32)
    return brick_dir, bricks


def build_render_grid_host(grids, cells, world_min, size_in_chunks, materials,
                           device="cuda"):
    """Host (NumPy) v1 RenderGrid builder (ops/wavefront.py:762-839).

    ``grids``: ``int32[B,32,32,32]`` pack-id voxel grids (axes x,y,z);
    ``cells``: ``int32[B]`` window-local chunk cell ``x + y*W + z*W²``
    (negative = unused slot). Every table equals the JAX builder's word
    for word; they land on ``device``: the card unless the caller asks for
    the CPU.
    """
    grids = np.asarray(grids, np.int32)
    cells = np.asarray(cells, np.int32)
    to_render, to_pack, n_liquid = render_id_maps(
        np.asarray(materials.is_liquid))

    w = size_in_chunks
    v = w * CHUNK_SIZE
    vpad = _cdiv(v, BWIN_VOX) * BWIN_VOX
    nb = vpad // BWIN_VOX
    brick_dir, bricks = _brick_tables_np(grids, cells, w, to_render, vpad)

    # per-brick flags from each row's 64 render ids (one byte each)
    ids = bricks.view(np.uint8).reshape(-1, 64)
    is_liq_v = (ids >= 1) & (ids <= n_liquid)
    descend = (ids > n_liquid).any(axis=1) | (
        is_liq_v.any(axis=1) & (ids == 0).any(axis=1))
    all_liq = is_liq_v.all(axis=1)
    has = brick_dir >= 0
    rows = brick_dir[has]

    def brick_windows(row_bits):
        bgrid = np.zeros(brick_dir.shape[0], dtype=np.uint32)
        bgrid[has] = row_bits[rows]
        g6 = bgrid.reshape(nb, BWIN, nb, BWIN, nb, BWIN)
        g6 = g6.transpose(0, 2, 4, 1, 3, 5)
        bits = g6.reshape(nb * nb * nb, 128, 32)
        return (bits << np.arange(32, dtype=np.uint32)).sum(
            axis=-1, dtype=np.uint64).astype(np.uint32)

    return RenderGrid(
        bwin=_i32(brick_windows(descend), device),
        lwin=_i32(brick_windows(all_liq), device),
        brick_dir=_i32(brick_dir, device),
        bricks=_i32(bricks, device),
        world_min=_i32(np.asarray(world_min, np.int32), device),
        to_pack=_i32(to_pack, device),
        n_liquid=int(n_liquid),
        size_voxels=v,
    )
