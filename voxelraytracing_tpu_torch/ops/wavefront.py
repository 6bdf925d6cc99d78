"""Shared tracer constants, render-id maps and the v1 brick-window world.

Port of the pieces of ``voxelraytracing_tpu/ops/wavefront.py`` that the
bit-plane tracers build on: the tile and brick constants, the render-id
maps, and the v1 :class:`RenderGrid` with its two builders: the host one
(:func:`build_render_grid_host`, NumPy) and the device one
(:func:`build_render_grid`, torch ops on the card unless the caller asks
for the CPU), whose tables are the same word for word. The v2 march
(``wavefront2.py``) reads them; the brick tables are also the v3 grid's.
The v1 tracer itself (a host loop of XLA programs) is not ported.

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


def _bits_i32(x):
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def build_render_grid_impl(grids, cells, world_min, to_render, to_pack,
                           n_liquid, size_in_chunks, device="cuda"):
    """Compile dense chunk grids into the v1 traversal tables on ``device``
    (ops/wavefront.py:152-234), in one pass of tensor ops.

    grids: ``int32[B,32,32,32]`` pack-id voxel grids (axes x,y,z).
    cells: ``int32[B]`` window-local flat chunk cell ``x + y*W + z*W²``
      (negative = unused slot).

    JAX scatters the brick bits and the directory rows with
    ``mode="drop"``, sending unused slots to the out-of-range brick
    ``S³``; here each target has one spare entry there, which takes those
    writes and is cut off. JAX sums the shifted uint32 bits; here the sums
    run in int64 (the bit sets are disjoint, so a sum is an OR) and land
    as int32 words with the same bits.
    """
    i32, i64 = torch.int32, torch.int64

    def on(x, dtype):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x.to(device=device, dtype=dtype)

    w = size_in_chunks
    v = w * CHUNK_SIZE
    vpad = _cdiv(v, BWIN_VOX) * BWIN_VOX
    nb = vpad // BWIN_VOX
    grids, cells = on(grids, i64), on(cells, i64)
    to_render = on(to_render, i64)
    b = grids.shape[0]

    # pack ids -> render ids (one-off world-build gather)
    rg = to_render[grids]  # [B,32,32,32]

    cx = cells % w
    cy = (cells // w) % w
    cz = cells // (w * w)
    valid = cells >= 0

    # ---- brick classification ------------------------------------------
    # Brick view: [B, Bx,vx, By,vy, Bz,vz] with 8 bricks and 4 voxels/axis.
    bview = rg.reshape(b, 8, BRICK, 8, BRICK, 8, BRICK)
    is_liq_v = (bview >= 1) & (bview <= n_liquid)
    ax = (2, 4, 6)
    any_solid = (bview > n_liquid).any(dim=ax[2]).any(dim=ax[1]).any(dim=ax[0])
    any_liq = is_liq_v.any(dim=ax[2]).any(dim=ax[1]).any(dim=ax[0])
    all_liq = is_liq_v.all(dim=ax[2]).all(dim=ax[1]).all(dim=ax[0])
    any_air = (bview == 0).any(dim=ax[2]).any(dim=ax[1]).any(dim=ax[0])
    descend = any_solid | (any_liq & any_air)  # [B,8,8,8]

    # global brick coords of each chunk's 8³ bricks
    bg_side = nb * BWIN
    ii = torch.arange(8, dtype=i64, device=device)
    gbx = ii[None, :, None, None] + (cx * 8)[:, None, None, None]
    gby = ii[None, None, :, None] + (cy * 8)[:, None, None, None]
    gbz = ii[None, None, None, :] + (cz * 8)[:, None, None, None]
    gflat = gbx + gby * bg_side + gbz * bg_side * bg_side
    gflat = torch.where(valid[:, None, None, None], gflat,
                        torch.full_like(gflat, bg_side ** 3)).reshape(-1)

    def brick_windows(bbits):
        """Scatter [B,8,8,8] per-chunk brick bits into window bit rows."""
        bgrid = torch.zeros(bg_side ** 3 + 1, dtype=i64, device=device)
        bgrid[gflat] = bbits.reshape(-1).to(i64)
        # flat = bx + by*S + bz*S² -> C reshape into (nb,16,nb,16,nb,16)
        # yields axes (zw, zl, yw, yl, xw, xl); regroup per window with the
        # in-window linear order bx + by*16 + bz*256 (x fastest).
        g6 = bgrid[: bg_side ** 3].reshape(nb, BWIN, nb, BWIN, nb, BWIN)
        bits = g6.permute(0, 2, 4, 1, 3, 5).reshape(nb * nb * nb, 128, 32)
        wshift = torch.arange(32, dtype=i64, device=device)
        return _bits_i32((bits << wshift).sum(dim=-1))

    bwin = brick_windows(descend)
    lwin = brick_windows(all_liq)

    # ---- brick contents + directory ------------------------------------
    # content row for chunk i, brick (bx,by,bz) = i*512 + bx*64 + by*8 + bz
    bc = bview.permute(0, 1, 3, 5, 6, 4, 2).reshape(b * 512, 16, 4)
    shifts = torch.arange(4, dtype=i64, device=device) * 8
    bricks = _bits_i32((bc << shifts).sum(dim=-1))  # [b*512, 16]

    li = (ii[:, None, None] * 64 + ii[None, :, None] * 8 + ii[None, None, :])
    rows = torch.arange(b, dtype=i64, device=device)[:, None, None, None] \
        * 512 + li
    brick_dir = torch.full((bg_side ** 3 + 1,), -1, dtype=i32, device=device)
    brick_dir[gflat] = rows.reshape(-1).to(i32)

    return RenderGrid(
        bwin=bwin,
        lwin=lwin,
        brick_dir=brick_dir[: bg_side ** 3].contiguous(),
        bricks=bricks,
        world_min=on(world_min, i32),
        to_pack=on(to_pack, i32),
        n_liquid=int(n_liquid),
        size_voxels=v,
    )


def build_render_grid(grids, cells, world_min, size_in_chunks, materials,
                      device="cuda"):
    """The v1 RenderGrid built on ``device`` (the card unless the caller
    asks for the CPU), the id maps derived from a MaterialTable
    (ops/wavefront.py:237-250); equal word for word to
    :func:`build_render_grid_host`'s."""
    to_render, to_pack, n_liquid = render_id_maps(
        np.asarray(materials.is_liquid))
    return build_render_grid_impl(grids, cells, world_min, to_render, to_pack,
                                  n_liquid, size_in_chunks, device=device)
