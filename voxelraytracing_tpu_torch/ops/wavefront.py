"""The v1 windowed wavefront tracer, its tables and the shared constants.

Port of ``voxelraytracing_tpu/ops/wavefront.py``: the tile and brick
constants, the render-id maps, the v1 :class:`RenderGrid` with its two
builders: the host one (:func:`build_render_grid_host`, NumPy) and the
device one (:func:`build_render_grid`, torch ops on the card unless the
caller asks for the CPU), whose tables are the same word for word, and
the v1 tracer :func:`trace_wavefront`, a host loop of plain PyTorch ops
on the grid's device (JAX's is a host loop of small XLA programs, with no
Pallas kernel). The v2 march (``wavefront2.py``) reads the same tables;
the brick tables are also the v3 grid's.

The tracer cuts the frame into 16x8-pixel tiles of 128 rays, all ray
state ``[n_tiles, 128]`` in component form. Empty space is crossed a 4³
brick at a time (or a whole 64³ window, when the window is uniform):
each tile carries the descend and all-liquid bit rows of one window.
Occupied bricks resolve voxel by voxel through 8 brick-content slots a
tile. Each round the tile points its window and slots at the rays found
from a rotating lane (rotation-fair service); rays whose window or brick
the tile lacks stall until a later round.

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
_BIG = 1e9  # DDA distance of an axis-degenerate direction
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


def _world_nb(rg):
    """Windows per edge of a v1 grid (JAX's round-then-fix-up of the cube
    root of its window count)."""
    nw3 = rg.bwin.shape[0]
    nb = int(round(nw3 ** (1 / 3)))
    while nb * nb * nb < nw3:
        nb += 1
    return nb


def _tile_rm(x, tx, ty, T):
    """[H, W(,C)] -> [T, 128(,C)] in row-major tile order (16x8 pixels a
    tile; zero rows pad to T), the v1 and v2 tracers' order."""
    extra = tuple(x.shape[2:])
    ne = len(extra)
    y = x.reshape((ty, TILE_H, tx, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + ne)))
    y = y.reshape((tx * ty, 128) + extra)
    return torch.nn.functional.pad(y, [0, 0] * ne + [0, 0, 0, T - tx * ty])


def _untile_rm(x, tx, ty, width, height):
    """Inverse of :func:`_tile_rm` (wavefront.py:684-688,
    wavefront2.py:750-754)."""
    extra = tuple(x.shape[2:])
    ne = len(extra)
    y = x[:tx * ty].reshape((ty, tx, TILE_H, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + ne)))
    return y.reshape((height, width) + extra)


# ----------------------------------------------------------------- tracing


def _dda3(px, py, pz, rays, cell):
    """One DDA step in component form (wavefront.py:283-301): exit
    distance of the ``cell``-sized cell (a tensor: 1, 4 or 64) containing
    p, plus per-axis crossing masks."""

    def axis(pc, iv, sgn):
        # ceil-1 for negative directions: identical off-boundary, but a
        # position exactly ON a plane targets the crossing strictly below
        # instead of returning dt == 0
        q = pc / cell
        b = torch.where(sgn > 0.5, torch.floor(q) + 1.0, torch.ceil(q) - 1.0)
        dt = (b * cell - pc) * iv
        return torch.where(iv.abs() >= 0.99 * _BIG_IV, _BIG, dt)

    dtx = axis(px, rays.ivx, rays.sx)
    dty = axis(py, rays.ivy, rays.sy)
    dtz = axis(pz, rays.ivz, rays.sz)
    dt = torch.minimum(dtx, torch.minimum(dty, dtz))
    return dt, dtx <= dt, dty <= dt, dtz <= dt


class _Rays(NamedTuple):
    """Per-frame constants, all ``[T, 128]`` (component form), and the
    camera position's components ``ox``, ``oy``, ``oz`` (0-d)."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ivx: torch.Tensor
    ivy: torch.Tensor
    ivz: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor
    t_exit: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor

    def pos(self, t):
        """The ray positions at ``t``, ``o + d*t`` rounded op by op."""
        return (self.ox + self.dx * t, self.oy + self.dy * t,
                self.oz + self.dz * t)


class _Carry(NamedTuple):
    t: torch.Tensor
    active: torch.Tensor
    hit: torch.Tensor
    level: torch.Tensor  # 0 brick, 1 voxel
    cur_brick: torch.Tensor  # flat brick id while at voxel level
    axmask: torch.Tensor  # bits 0..2: axes crossed by the last step
    vox: torch.Tensor  # render id at hit
    water: torch.Tensor
    wenter: torch.Tensor  # -1 when not submerged
    steps: torch.Tensor
    bw_id: torch.Tensor  # [T]
    slot_bricks: torch.Tensor  # [T, N_SLOTS]
    slot_content: torch.Tensor  # [T, N_SLOTS]


def _prep_inv(c):
    """Guarded reciprocal: each component clamped to at least 1e-7 in
    magnitude first, so no Inf (wavefront.py:364-373). A tensor division:
    torch on CUDA divides by a host scalar as a reciprocal multiply."""
    c2 = torch.where(c >= 0, torch.clamp_min(c, 1e-7),
                     torch.clamp_max(c, -1e-7))
    return torch.ones_like(c2) / c2


def _prep(origin, dirs, *, tx, ty, v):
    """Per-frame setup (wavefront.py:351-427): the rays of the 16x8 tiles
    and the initial carry. Every ray starts at ``EPS_T``; a camera outside
    ``(0, v)³`` starts every ray inactive (ray_tracer.wgsl:197-200)."""
    f32, i32 = torch.float32, torch.int32
    dev = origin.device
    n_tiles = tx * ty
    d = _tile_rm(dirs, tx, ty, n_tiles)
    dx, dy, dz = (d[..., k].contiguous() for k in range(3))
    ivx, ivy, ivz = _prep_inv(dx), _prep_inv(dy), _prep_inv(dz)

    def slab(oc, iv):
        return torch.maximum((0.0 - oc) * iv, (float(v) - oc) * iv)

    o = origin
    t_exit = torch.clamp_max(
        torch.minimum(slab(o[0], ivx),
                      torch.minimum(slab(o[1], ivy), slab(o[2], ivz))),
        float(np.float32(4.0 * v + 16.0)))
    rays = _Rays(dx=dx, dy=dy, dz=dz, ivx=ivx, ivy=ivy, ivz=ivz,
                 sx=(dx > 0.0).to(f32), sy=(dy > 0.0).to(f32),
                 sz=(dz > 0.0).to(f32), t_exit=t_exit, ox=o[0], oy=o[1],
                 oz=o[2])
    shape = (n_tiles, 128)
    inside = ((o > 0.0) & (o < v)).all()
    full = dict(device=dev)
    carry = _Carry(
        t=torch.full(shape, EPS_T, dtype=f32, **full),
        active=inside.expand(shape).contiguous(),
        hit=torch.zeros(shape, dtype=torch.bool, **full),
        level=torch.zeros(shape, dtype=i32, **full),
        cur_brick=torch.full(shape, -1, dtype=i32, **full),
        axmask=torch.zeros(shape, dtype=i32, **full),
        vox=torch.zeros(shape, dtype=i32, **full),
        water=torch.zeros(shape, dtype=f32, **full),
        wenter=torch.full(shape, -1.0, dtype=f32, **full),
        steps=torch.zeros(shape, dtype=i32, **full),
        bw_id=torch.full((n_tiles,), -1, dtype=i32, **full),
        slot_bricks=torch.full((n_tiles, N_SLOTS), -1, dtype=i32, **full),
        slot_content=torch.full((n_tiles, N_SLOTS), -1, dtype=i32, **full),
    )
    return rays, carry


def _refetch(brick_dir, rays, c: _Carry, rot, *, nb, w64):
    """Service rays by rotation fairness (wavefront.py:430-482): each
    tile points its brick window at the first active brick-level ray at or
    after lane ``rot``, and its 8 content slots at the voxel-level rays
    found from ``rot + k*16``; a slot whose brick has no content
    (``brick_dir < 0``) reads -1. ``w64`` is the window edge, 64.0, as a
    tensor on the grid's device."""
    i32 = torch.int32
    lanes = torch.arange(128, dtype=i32, device=c.t.device)[None, :]

    def first_active_from(mask, rot_k):
        # score: 128 - distance from the rotation point, 0 if inactive
        score = torch.where(mask, 128 - ((lanes - rot_k) & 127), 0)
        return torch.argmax(score, dim=1), mask.any(dim=1)

    def lane_select(arr, si):
        return torch.gather(arr, 1, si[:, None])[:, 0]

    px, py, pz = rays.pos(c.t)
    bmask = c.active & (c.level == 0)
    bi, bhas = first_active_from(bmask, rot)

    def wcoord(pc):
        sel = lane_select(pc, bi)
        return torch.clamp(torch.floor(sel / w64).to(i32), 0, nb - 1)

    bw_target = wcoord(px) + wcoord(py) * nb + wcoord(pz) * nb * nb
    bw_id = torch.where(bhas, bw_target, c.bw_id)

    vmask = c.active & (c.level == 1)
    slots = []
    for k in range(N_SLOTS):
        si, has = first_active_from(vmask, rot + k * (128 // N_SLOTS))
        slots.append(torch.where(has, lane_select(c.cur_brick, si), -1))
    slot_bricks = torch.stack(slots, dim=1)

    dir_idx = torch.clamp(slot_bricks, 0, brick_dir.shape[0] - 1).long()
    content = brick_dir[dir_idx]
    slot_bricks = torch.where(content >= 0, slot_bricks, -1)
    return c._replace(bw_id=bw_id, slot_bricks=slot_bricks,
                      slot_content=content)


def _rows_win(bwin, lwin, bw_id):
    """Each tile's window bit rows, and whether the window may be jumped
    whole (no descend bit, uniformly liquid or uniformly dry)."""
    row_idx = torch.clamp(bw_id, 0, bwin.shape[0] - 1).long()
    bw_row = bwin[row_idx]
    lw_row = lwin[row_idx]
    no_descend = (bw_row == 0).all(dim=1)
    uniform_liq = (lw_row == -1).all(dim=1) | (lw_row == 0).all(dim=1)
    return bw_row, lw_row, no_descend & uniform_liq


def _rows_slots(bricks, slot_content):
    """Each tile's 8 content slots as one row of 128 words."""
    n_tiles = slot_content.shape[0]
    rows = bricks[torch.clamp(slot_content, 0, bricks.shape[0] - 1).long()]
    return rows.reshape(n_tiles, N_SLOTS * 16)


class _Geom(NamedTuple):
    """What a step derives from the pre-step positions: the positions,
    brick coordinates, the brick's bit in its window (``lin``) and the
    voxel's index in its brick (``vlin``)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor
    lin: torch.Tensor
    vlin: torch.Tensor


def _pre(rays, c: _Carry):
    """A step's gather indices (wavefront.py:504-532): the window word of
    each ray's brick, and the content word of its voxel in the slot
    holding its brick (the last matching slot: two can hold one brick).
    Also returns the step's :class:`_Geom`, which JAX recomputes in each
    of its programs."""
    i32 = torch.int32
    px, py, pz = rays.pos(c.t)
    bx = torch.floor(px * (1.0 / BRICK)).to(i32)
    by = torch.floor(py * (1.0 / BRICK)).to(i32)
    bz = torch.floor(pz * (1.0 / BRICK)).to(i32)
    lin = (bx & (BWIN - 1)) + (by & (BWIN - 1)) * BWIN \
        + (bz & (BWIN - 1)) * BWIN * BWIN
    widx = lin >> 5
    sidx = torch.zeros_like(c.cur_brick)
    for s_i in range(N_SLOTS):
        m = c.cur_brick == c.slot_bricks[:, s_i][:, None]
        sidx = torch.where(m, s_i, sidx)
    vx = torch.floor(px).to(i32)
    vy = torch.floor(py).to(i32)
    vz = torch.floor(pz).to(i32)
    vlin = (vx & (BRICK - 1)) + (vy & (BRICK - 1)) * BRICK \
        + (vz & (BRICK - 1)) * BRICK * BRICK
    vidx = sidx * 16 + (vlin >> 2)
    return widx, vidx, _Geom(px, py, pz, bx, by, bz, lin, vlin)


def _gather3(bw_row, lw_row, slot_row, widx, vidx):
    """The three lane-local lookups."""
    widx = widx.long()
    return (torch.gather(bw_row, 1, widx), torch.gather(lw_row, 1, widx),
            torch.gather(slot_row, 1, vidx.long()))


def _post_brick(rays, c: _Carry, g: _Geom, bw_jump, word, lword, *, nb,
                bg_side, cells):
    """Consume the brick-window lookups (wavefront.py:545-594):
    demotion when a voxel-level ray's brick changed, promotion into
    descend bricks, brick-level water accounting, the brick or window DDA
    advance. ``cells`` is (4.0, 64.0) as tensors on the grid's device."""
    i32 = torch.int32
    px, py, pz, bx, by, bz, lin = g[:7]
    active = c.active & (c.t < rays.t_exit)

    fb = bx + by * bg_side + bz * bg_side * bg_side
    level = torch.where(active & (c.level == 1) & (fb != c.cur_brick), 0,
                        c.level)

    bl = active & (level == 0)
    # arithmetic >> 4, as JAX's on int32: a brick below 0 is a window < 0
    bw_flat = (bx >> 4) + (by >> 4) * nb + (bz >> 4) * nb * nb
    match_b = bl & (bw_flat == c.bw_id[:, None])
    shift = lin & 31
    descend = ((word >> shift) & 1) != 0
    brick_liq = ((lword >> shift) & 1) != 0

    to_voxel = match_b & descend
    level = torch.where(to_voxel, 1, level)
    cur_brick = torch.where(to_voxel, fb, c.cur_brick)

    bstep = match_b & ~descend
    in_w = c.wenter >= 0.0
    leave_b = bstep & in_w & ~brick_liq
    water = c.water + torch.where(leave_b, c.t - c.wenter, 0.0)
    wenter = torch.where(leave_b, -1.0, c.wenter)
    wenter = torch.where(bstep & brick_liq & (wenter < 0.0), c.t, wenter)

    cell = torch.where(bw_jump[:, None], cells[1], cells[0])
    dt_b, cbx, cby, cbz = _dda3(px, py, pz, rays, cell)
    t = torch.where(bstep, c.t + dt_b + EPS_T, c.t)
    axb = cbx.to(i32) | (cby.to(i32) << 1) | (cbz.to(i32) << 2)
    axmask = torch.where(bstep, axb, c.axmask)
    steps = c.steps + match_b.to(i32)
    return c._replace(t=t, active=active, level=level, cur_brick=cur_brick,
                      axmask=axmask, water=water, wenter=wenter, steps=steps)


def _post_voxel(rays, c: _Carry, g: _Geom, n_liquid, vword, pre_level,
                pre_cur_brick, one):
    """Consume the brick-content lookup (wavefront.py:597-655): hits,
    voxel-level water accounting, the single-voxel DDA advance.

    ``vword`` was gathered with a slot index from the pre-step carry, so
    only rays that were at voxel level before :func:`_post_brick` and
    whose brick did not change may consume it; any other would read
    another brick's content. ``one`` is 1.0 as a tensor on the grid's
    device (the voxel DDA's cell).

    JAX recomputes the positions here from the ``t`` that
    :func:`_post_brick` left; this takes the pre-step ones of ``g``. They
    differ only on rays that took a brick step, which end the step at
    brick level, so no ray this function writes (``match_v``) sees the
    difference."""
    i32 = torch.int32
    px, py, pz = g.px, g.py, g.pz
    vl = (c.active & (c.level == 1) & (pre_level == 1)
          & (pre_cur_brick == c.cur_brick))
    in_slot = torch.zeros_like(vl)
    for s_i in range(N_SLOTS):
        in_slot = in_slot | (c.cur_brick == c.slot_bricks[:, s_i][:, None])
    match_v = vl & in_slot
    rid = (vword >> ((g.vlin & 3) * 8)) & 0xFF

    is_air = rid == 0
    is_liq = (rid >= 1) & (rid <= n_liquid)
    solid = match_v & ~is_air & ~is_liq

    hit = c.hit | solid
    active = c.active & ~solid
    vox = torch.where(solid, rid, c.vox)

    in_w = c.wenter >= 0.0
    leave_v = match_v & in_w & ~is_liq
    water = c.water + torch.where(leave_v, c.t - c.wenter, 0.0)
    wenter = torch.where(leave_v, -1.0, c.wenter)
    wenter = torch.where(match_v & is_liq & (wenter < 0.0), c.t, wenter)

    vstep = match_v & (is_air | is_liq)
    dt_v, cvx, cvy, cvz = _dda3(px, py, pz, rays, one)
    t = torch.where(vstep, c.t + dt_v + EPS_T, c.t)
    axv = cvx.to(i32) | (cvy.to(i32) << 1) | (cvz.to(i32) << 2)
    axmask = torch.where(vstep, axv, c.axmask)
    steps = c.steps + match_v.to(i32)
    return c._replace(t=t, active=active, hit=hit, axmask=axmask, vox=vox,
                      water=water, wenter=wenter, steps=steps)


def _finish(to_pack, rays, c: _Carry, *, width, height, tx, ty):
    """The :class:`WavefrontResult` (wavefront.py:663-696): a ray that
    used up its budget without a hit is a miss; a submerged ray gets water
    credit up to ``min(t, t_exit)``."""
    f32 = torch.float32
    t_stop = torch.minimum(c.t, rays.t_exit)
    water = c.water + torch.where(c.wenter >= 0.0, t_stop - c.wenter, 0.0)
    norm = torch.stack(
        [-torch.sign(d) * ((c.axmask >> k) & 1).to(f32)
         for k, d in enumerate((rays.dx, rays.dy, rays.dz))], dim=-1)
    voxel = to_pack[torch.clamp(c.vox, 0, 255).long()]

    def untile(x):
        return _untile_rm(x, tx, ty, width, height)

    return WavefrontResult(hit=untile(c.hit), voxel=untile(voxel),
                           norm=untile(norm), t=untile(t_stop),
                           water_dist=untile(water), steps=untile(c.steps))


def trace_wavefront(rg: RenderGrid, origin, dirs, *, width, height,
                    max_rounds=64, inner_steps=12):
    """March one frame of rays through a v1 :class:`RenderGrid`
    (wavefront.py:699-759) -> a :class:`WavefrontResult` of ``[H, W]``
    maps on the grid's device.

    ``origin`` f32[3] (world-local camera position, shared by all rays)
    and ``dirs`` f32[H,W,3] unit directions, as ``generate_rays_raw``
    makes them; the frame must be whole 16x8 tiles. Up to ``max_rounds``
    rounds, each a refetch and ``inner_steps`` steps. The loop ends early
    once no ray is active, which changes no product (an inactive ray is
    never written); that test is one host sync a round. A ray still
    active after the last round renders as a miss.
    """
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"frame {width}x{height} is not whole 16x8 tiles")
    f32 = torch.float32
    dev = rg.bwin.device
    tx, ty = width // TILE_W, height // TILE_H
    nb = _world_nb(rg)
    bg_side = nb * BWIN
    origin = torch.as_tensor(origin, dtype=f32).to(dev).reshape(3)
    dirs = torch.as_tensor(dirs, dtype=f32).to(dev)
    rays, carry = _prep(origin, dirs, tx=tx, ty=ty, v=int(rg.size_voxels))
    # cell edges as device tensors: every division here is a tensor one
    one, c4, c64 = (torch.tensor(x, dtype=f32, device=dev)
                    for x in (1.0, float(BRICK), float(BWIN_VOX)))
    for r in range(int(max_rounds)):
        rot = (r * 37) & 127  # co-prime stride covers all lanes
        carry = _refetch(rg.brick_dir, rays, carry, rot, nb=nb, w64=c64)
        bw_row, lw_row, bw_jump = _rows_win(rg.bwin, rg.lwin, carry.bw_id)
        slot_row = _rows_slots(rg.bricks, carry.slot_content)
        for _ in range(int(inner_steps)):
            pre_level, pre_cur_brick = carry.level, carry.cur_brick
            widx, vidx, g = _pre(rays, carry)
            word, lword, vword = _gather3(bw_row, lw_row, slot_row, widx,
                                          vidx)
            carry = _post_brick(rays, carry, g, bw_jump, word, lword, nb=nb,
                                bg_side=bg_side, cells=(c4, c64))
            carry = _post_voxel(rays, carry, g, rg.n_liquid, vword,
                                pre_level, pre_cur_brick, one)
        if not bool(carry.active.any()):
            break
    return _finish(rg.to_pack, rays, carry, width=width, height=height,
                   tx=tx, ty=ty)
