"""Subwindow bit-plane world (v3 tables) and the frame layout.

Port of the host builders and frame helpers of
``voxelraytracing_tpu/ops/wavefront3.py``. The world is a stack of bit
planes at three levels: per-window meta (64³ voxels), per-subwindow meta
and voxel rows (16³ voxels = 4096 bits = one 128-word row), and a global
plane of jumpable windows. A ray classifies each step from its position
alone; the march itself lives in ``wavefront4.py``.

Bit words are carried as ``torch.int32`` with the bits of the JAX
package's ``uint32`` words: torch's uint32 has no shifts, compares or
gathers. Convert at the boundary with ``.numpy().view(np.uint32)``.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import CHUNK_SIZE
from .camera import sqrt_rn
from .wavefront import TILE_H, TILE_W, _cdiv, render_id_maps

SW = 16       # subwindow edge, voxels (one 128-word bit row)
WIN = 64      # window edge, voxels (4³ subwindows)
_BLK = 64     # tiles per superblock (8K rays)
SB_W = 8      # tiles per superblock, x  (SB_W*SB_H == _BLK)
SB_H = 8      # tiles per superblock, y


def _sb_dims(tx, ty):
    """Superblock grid dims + padded tile count for a (tx, ty) tile grid.

    Tiles are ordered superblock-major: superblock ``sb`` covers the
    8x8-tile (128x64-pixel) patch at ``(sb % nsx, sb // nsx)``."""
    nsx = -(-tx // SB_W)
    nsy = -(-ty // SB_H)
    return nsx, nsy, nsx * nsy * _BLK


class RenderGrid3(NamedTuple):
    """Bit-plane world for the v3/v4 tracers (all bit words int32).

    gw_jump/gw_liq: ``[1,128]`` global window bits (word w>>5, bit w&31;
      window id w = wx + wy*Nw + wz*Nw²). Worlds past 16 windows per axis
      store 2^gs-window SUPER-CELL bits on a <=16³ grid (gs = _gs_for(Nw)).
    wmeta: ``[Nw³, 8]`` per-window meta — words 0-1: subwindow jumpable
      bits, words 2-3: subwindow all-liquid bits (local subwindow
      s = sx + sy*4 + sz*16), words 4-7 zero.
    sw_meta: ``[Ns³, 8]`` per-subwindow meta — words 0-1: brick jumpable
      bits, 2-3: brick all-liquid bits (local brick b = bx + by*4 +
      bz*16); words 4-7: the 16-entry solid-id palette (pack ids, one byte
      per entry).
    sw_solid/sw_liq: ``[Ns³, 128]`` per-voxel bit rows (local voxel
      l = lx + ly*16 + lz*256 -> word l>>5, bit l&31).
    sw_pid: ``[Ns³, 4, 128]`` per-voxel palette-index bit planes.
    to_pack: ``int32[256]`` render id -> pack id; n_liquid: render ids
      1..n_liquid are liquids.
    palettes_ok: False when some subwindow holds more than 16 distinct
      solid ids: those ids decode from the overflowed palette (its most
      frequent entry), as in the JAX package's v4 frame, and the renderer
      logs a warning.
    """

    gw_jump: torch.Tensor
    gw_liq: torch.Tensor
    wmeta: torch.Tensor
    sw_meta: torch.Tensor
    sw_solid: torch.Tensor
    sw_liq: torch.Tensor
    sw_pid: torch.Tensor
    world_min: torch.Tensor
    to_pack: torch.Tensor
    n_liquid: int
    size_voxels: int
    palettes_ok: bool


def _i32(a, device):
    """NumPy integer words -> int32 tensor (a copy) with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a.astype(np.int32, copy=False), device=device)


# ----------------------------------------------------------------- builders


def _pack_bits_np(bits):
    """[N, 32k] bool -> [N, k] uint32, bit i of word w = column w*32+i."""
    n, m = bits.shape
    b = bits.reshape(n, m // 32, 32).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(
        axis=-1, dtype=np.uint64
    ).astype(np.uint32)


def build_sw_palettes(vol_rows, solid_rows, to_pack):
    """Per-subwindow solid-id palettes + 4 palette-index bit planes.

    Returns ``(pal_words u32[N,4], sw_pid u32[N,4,128], palettes_ok)``.

    Overflow policy: a 16³ subwindow with more than 16 distinct solid ids
    keeps its 16 MOST FREQUENT ids and maps the rest to the most frequent
    one, and ``palettes_ok`` goes False.
    """
    n_sw = vol_rows.shape[0]
    vr = vol_rows.astype(np.int64)
    # per-(row, id) solid counts (render ids are < 256); non-solid voxels
    # land in each row's id-0 column, which is dropped (id 0 = air). One
    # flat bincount with int64 keys: the JAX package's own fallback for
    # its native row histogram, and equal to it.
    ids = np.where(solid_rows, vr, 0)
    flat = (np.arange(n_sw, dtype=np.int64)[:, None] * 256 + ids).ravel()
    cnt = np.bincount(flat, minlength=n_sw * 256).reshape(n_sw, 256)
    cnt[:, 0] = 0
    present = cnt > 0
    n_ids = present.sum(axis=1)
    over = n_ids > 16
    palettes_ok = not bool(over.any())

    # palette order: ascending id for <=16-id rows; for overflow rows,
    # count-desc with id-asc tiebreak (deterministic)
    ids256 = np.arange(256, dtype=np.int64)[None]
    absent = np.int64(1) << 22
    key_asc = np.where(present, ids256, absent)
    key_cnt = np.where(present, -(cnt.astype(np.int64) << 9) + ids256,
                       absent)
    key = np.where(over[:, None], key_cnt, key_asc)
    pal_ids = np.argsort(key, axis=1, kind="stable")[:, :16]   # [N,16] ids
    k_valid = np.arange(16)[None, :] < np.minimum(n_ids, 16)[:, None]
    pal_ids = np.where(k_valid, pal_ids, 0)

    # per-row LUT id -> palette index; ids outside the palette (overflow)
    # keep 0 = the most-frequent entry
    lut = np.zeros((n_sw, 256), np.uint8)
    np.put_along_axis(
        lut, pal_ids,
        (np.arange(16, dtype=np.uint8)[None] * k_valid).astype(np.uint8),
        axis=1,
    )
    pidx = np.take_along_axis(lut, vr, axis=1)

    pal = np.where(k_valid, np.asarray(to_pack)[pal_ids], 0).astype(
        np.uint32)
    pal_words = (
        pal.reshape(n_sw, 4, 4)
        << (np.arange(4, dtype=np.uint32) * 8)[None, None]
    ).sum(axis=2, dtype=np.uint64).astype(np.uint32)
    sw_pid = np.stack(
        [_pack_bits_np(((pidx >> b) & 1) != 0) for b in range(4)], axis=1
    )
    return pal_words, sw_pid, palettes_ok


def build_render_grid3_host(grids, cells, world_min, size_in_chunks,
                            materials, device="cuda"):
    """Host (NumPy) RenderGrid3 builder from per-chunk dense grids.

    ``grids``: ``int32[B,32,32,32]`` pack-id voxel grids (axes x,y,z);
    ``cells``: ``int32[B]`` window-local chunk cell ``x + y*W + z*W²``
    (negative = unused slot). The planes land on ``device``: the card
    unless the caller asks for the CPU.
    """
    grids = np.asarray(grids, np.int32)
    cells = np.asarray(cells, np.int32)
    to_render, to_pack, n_liquid = render_id_maps(
        np.asarray(materials.is_liquid))

    w = size_in_chunks
    v = w * CHUNK_SIZE
    vpad = _cdiv(v, WIN) * WIN
    rgv = to_render[grids].astype(np.uint8)

    vol = np.zeros((vpad, vpad, vpad), np.uint8)
    for b in range(grids.shape[0]):
        c = int(cells[b])
        if c < 0:
            continue
        cx, cy, cz = c % w, (c // w) % w, c // (w * w)
        vol[
            cx * CHUNK_SIZE:(cx + 1) * CHUNK_SIZE,
            cy * CHUNK_SIZE:(cy + 1) * CHUNK_SIZE,
            cz * CHUNK_SIZE:(cz + 1) * CHUNK_SIZE,
        ] = rgv[b]

    solid = vol > n_liquid
    liq = (vol >= 1) & (vol <= n_liquid)
    planes, palettes_ok = _planes_from_masks_np(
        solid, liq, vpad, vol=vol, to_pack=to_pack
    )
    return RenderGrid3(
        *[_i32(p, device) for p in planes],
        world_min=_i32(np.asarray(world_min, np.int32), device),
        to_pack=_i32(to_pack, device),
        n_liquid=int(n_liquid),
        size_voxels=v,
        palettes_ok=bool(palettes_ok),
    )


def _gs_for(nw):
    """Global-plane super-cell shift for an ``nw``-window world.

    The global plane is one 4096-bit row (16³ granularity). Worlds past
    16 windows per axis coarsen each bit to a 2^gs-window SUPER-CELL: gs
    is the smallest shift with ceil(nw/2^gs) <= 16. A set bit means every
    covered window is jumpable with uniform liquidity, so the march jumps
    (WIN<<gs)-voxel cells through it."""
    gs = 0
    while ((nw + (1 << gs) - 1) >> gs) > 16:
        gs += 1
    if gs > 3:
        raise ValueError("global plane supports <=128³ windows (256 chunks)")
    return gs


def _super_gplanes_np(w_jump, w_all_liq, nw):
    """Reduce per-window flags to the [1,128]-packed super-cell planes.

    ``w_jump``/``w_all_liq``: flat [nw³] bools, index X + Y*nw + Z*nw².
    Returns (gw_jump, gw_liq) u32[1,128]. Pad windows never contain
    geometry: jump=True, any-liq=False, all-liq=True."""
    gs = _gs_for(nw)
    nwg = (nw + (1 << gs) - 1) >> gs
    gsh = 1 << gs

    def grid(flat, pad):
        t = flat.reshape(nw, nw, nw)                 # (Z, Y, X)
        p = nwg * gsh - nw
        return np.pad(t, ((0, p),) * 3, constant_values=pad)

    def cells(g):
        return g.reshape(nwg, gsh, nwg, gsh, nwg, gsh)

    all_jump = cells(grid(w_jump, True)).all(axis=(1, 3, 5))
    all_liq = cells(grid(w_all_liq, True)).all(axis=(1, 3, 5))
    any_liq = cells(grid(w_all_liq, False)).any(axis=(1, 3, 5))
    sj = all_jump & (all_liq | ~any_liq)             # uniform liquidity
    sl = sj & all_liq & any_liq

    def gplane(bits):
        pad = np.zeros(4096, bool)
        pad[: bits.size] = bits.reshape(-1)          # (Z,Y,X) flat
        return _pack_bits_np(pad.reshape(1, 4096))   # [1,128]

    return gplane(sj), gplane(sl)


def _planes_from_masks_np(solid, liq, vpad, vol=None, to_pack=None):
    """NumPy: (solid, liq) [V,V,V] bool -> (seven v3 plane arrays, pal_ok).

    ``vol`` ([V,V,V] render ids) and ``to_pack`` drive the per-subwindow
    solid-id palettes; palettes hold *pack* ids so hit decode needs no
    further mapping.
    """
    ns = vpad // SW
    nw = vpad // WIN

    def sw_rows(m):
        t = m.reshape(ns, SW, ns, SW, ns, SW)       # (X,xl,Y,yl,Z,zl)
        t = t.transpose(4, 2, 0, 5, 3, 1)           # (Z,Y,X, zl,yl,xl)
        return t.reshape(ns * ns * ns, SW * SW * SW)

    sw_solid = _pack_bits_np(sw_rows(solid))
    sw_liq = _pack_bits_np(sw_rows(liq))

    vol_rows = sw_rows(vol)                          # [Ns³,4096] render ids
    solid_rows = sw_rows(solid)
    pal_words, sw_pid, palettes_ok = build_sw_palettes(
        vol_rows, solid_rows, to_pack
    )

    # Per-brick (4³ within a subwindow) flags.
    def brick_reduce(m, op):
        t = m.reshape(ns, 4, 4, ns, 4, 4, ns, 4, 4)  # (X,bx,vx,Y,by,vy,Z,bz,vz)
        r = op(t, (2, 5, 8))                         # (X,bx,Y,by,Z,bz)
        r = r.transpose(4, 2, 0, 5, 3, 1)            # (Z,Y,X, bz,by,bx)
        return r.reshape(ns * ns * ns, 64)

    b_any_solid = brick_reduce(solid, np.ndarray.any)
    b_all_liq = brick_reduce(liq, np.ndarray.all)
    b_any_liq = brick_reduce(liq, np.ndarray.any)
    b_jump = ~b_any_solid & (b_all_liq | ~b_any_liq)

    def pack_meta(jump64, liq64):
        n = jump64.shape[0]
        meta = np.zeros((n, 8), np.uint32)
        meta[:, 0:2] = _pack_bits_np(jump64)
        meta[:, 2:4] = _pack_bits_np(liq64)
        return meta

    sw_meta = pack_meta(b_jump, b_all_liq)
    sw_meta[:, 4:8] = pal_words

    # Per-subwindow flags -> window meta ((Z,Y,X) rows; order="F"
    # restores [X,Y,Z] indexing)
    s_any_solid = b_any_solid.any(axis=1).reshape(ns, ns, ns, order="F")
    s_all_liq = b_all_liq.all(axis=1).reshape(ns, ns, ns, order="F")
    s_any_liq = b_any_liq.any(axis=1).reshape(ns, ns, ns, order="F")
    s_jump = ~s_any_solid & (s_all_liq | ~s_any_liq)

    def win_bits(m):                                  # m: [ns,ns,ns] (X,Y,Z)
        t = m.reshape(nw, 4, nw, 4, nw, 4)            # (X,sx,Y,sy,Z,sz)
        t = t.transpose(4, 2, 0, 5, 3, 1)             # (Z,Y,X, sz,sy,sx)
        return t.reshape(nw * nw * nw, 64)

    wmeta = pack_meta(win_bits(s_jump), win_bits(s_all_liq))

    w_any_solid = win_bits(s_any_solid).any(axis=1)
    w_all_liq = win_bits(s_all_liq).all(axis=1)
    w_any_liq = win_bits(s_any_liq).any(axis=1)
    w_jump = ~w_any_solid & (w_all_liq | ~w_any_liq)

    gw_jump, gw_liq = _super_gplanes_np(w_jump, w_jump & w_all_liq, nw)
    planes = (gw_jump, gw_liq, wmeta, sw_meta, sw_solid, sw_liq, sw_pid)
    return planes, palettes_ok


# ------------------------------------------------------------- frame layout

# flags word layout (bit): 0 active, 1 hit, 2-4 axmask, 5-16 steps,
# 17-24 vox (pack id from the subwindow palette), 25-27 direction signs
_FL_ACT = 0
_FL_HIT = 1
_FL_AX = 2
_FL_STP = 5
_FL_VOX = 17
_FL_SGN = 25  # 3 direction-sign bits (dx>0, dy>0, dz>0)
_SCAL_N = 27  # length of the _cam_scal row; the shade scalars follow it


def _cam_scal(origin, inv_view, inv_proj, v, width, full_height, y0):
    """Host f32[27] scalar row for the ray directions + world bounds.

    Same values, bit for bit, as the JAX row: ``scal[4]`` is ``2/width``
    divided in double and rounded to f32, ``scal[5]`` is ``2/height``
    divided in f32; 21 = band y0; 22-26 are filled by the caller (srd,
    step cap, init flag, tx, ty)."""
    f32 = np.float32
    ip = np.asarray(inv_proj, f32)
    iv = np.asarray(inv_view, f32)
    return np.concatenate([
        np.asarray(origin, f32).reshape(3),
        np.asarray([v], f32),
        np.asarray([2.0 / width], f32),
        f32(2.0) / np.asarray([full_height], f32),
        np.stack([
            ip[0, 0], ip[1, 0], -ip[2, 0] + ip[3, 0],
            ip[0, 1], ip[1, 1], -ip[2, 1] + ip[3, 1],
        ]),
        iv[0, :3], iv[1, :3], iv[2, :3],
        np.asarray([y0], f32),
        np.zeros(5, f32),
    ]).astype(f32)


def _pixel_dirs(scal, px, py):
    """Unit directions of pixels ``(px, py)`` (f32 tensors) from the camera
    affine in ``scal`` (Python floats holding f32 values). One rounding per
    multiply and add, in the JAX op order, and a division by a correctly
    rounded ``sqrt``: the CUDA kernel does the same sequence."""
    x = px * scal[4] - 1.0
    y = py * scal[5] - 1.0
    ex = x * scal[6] - y * scal[7] + scal[8]
    ey = x * scal[9] - y * scal[10] + scal[11]
    dx = ex * scal[12] + ey * scal[15] - scal[18]
    dy = ex * scal[13] + ey * scal[16] - scal[19]
    dz = ex * scal[14] + ey * scal[17] - scal[20]
    n = sqrt_rn(dx * dx + dy * dy + dz * dz)
    return dx / n, dy / n, dz / n


def _tile_xy(tg, nsx):
    """Tile grid coordinates of superblock-major tile indices."""
    sb = tg // _BLK
    li = tg - sb * _BLK
    return (sb % nsx) * SB_W + li % SB_W, (sb // nsx) * SB_H + li // SB_W


def _ray_dirs(scal, tg, lane, nsx):
    """Per-ray directions for tile indices ``tg`` and lanes ``lane``."""
    scal = [float(s) for s in scal]
    txi, tyi = _tile_xy(tg, nsx)
    px = (txi * TILE_W + lane % TILE_W).to(torch.float32)
    py = (tyi * TILE_H + lane // TILE_W).to(torch.float32) + scal[21]
    return _pixel_dirs(scal, px, py)


def _tile_hw(x, tx, ty, T):
    """[H, W(,C)] -> [T, 128(,C)] superblock-major tile layout (16x8 pixels
    per 128-lane row, 8x8 tiles per superblock; edge superblocks pad)."""
    nsx, nsy, T2 = _sb_dims(tx, ty)
    if T2 != T:
        raise ValueError(f"tile count {T} != {T2} for a {tx}x{ty} grid")
    ne = len(x.shape[2:])
    extra = tuple(x.shape[2:])
    y = x.reshape((ty, TILE_H, tx, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3) + tuple(range(4, 4 + ne)))
    pad = [0, 0] * ne + [0, 0, 0, 0, 0, nsx * SB_W - tx, 0, nsy * SB_H - ty]
    y = torch.nn.functional.pad(y, pad)
    y = y.reshape((nsy, SB_H, nsx, SB_W, TILE_H, TILE_W) + extra)
    y = y.permute((0, 2, 1, 3, 4, 5) + tuple(range(6, 6 + ne)))
    return y.reshape((T, 128) + extra)


def _untile_hw(x, tx, ty, width, height):
    """Inverse of _tile_hw: [T, 128(,C)] -> [height, width(,C)]."""
    nsx, nsy, _ = _sb_dims(tx, ty)
    ne = len(x.shape[2:])
    extra = tuple(x.shape[2:])
    y = x.reshape((nsy, nsx, SB_H, SB_W, TILE_H, TILE_W) + extra)
    y = y.permute((0, 2, 4, 1, 3, 5) + tuple(range(6, 6 + ne)))
    y = y.reshape((nsy * SB_H * TILE_H, nsx * SB_W * TILE_W) + extra)
    return y[:height, :width]


def _tile_valid(tx, ty, T, device="cpu"):
    """bool[T, 128]: tiles that carry real pixels (edge superblocks pad)."""
    nsx, _, _ = _sb_dims(tx, ty)
    tile_i = torch.arange(T, dtype=torch.int32, device=device)[:, None]
    txi, tyi = _tile_xy(tile_i.expand(T, 128), nsx)
    return (txi < tx) & (tyi < ty)


def color_lut_rows(colors):
    """[n,3] f32 material colors -> [6,128] LUT rows (r0 r1 g0 g1 b0 b1)."""
    c = np.zeros((256, 3), np.float32)
    cn = np.asarray(colors, np.float32)
    c[: len(cn)] = cn[:256]
    rows = np.zeros((6, 128), np.float32)
    for ch in range(3):
        rows[ch * 2] = c[:128, ch]
        rows[ch * 2 + 1] = c[128:, ch]
    return torch.from_numpy(rows)


def material_lut_rows(color, emission, scatter):
    """Material tables -> [10,128] f32 LUT rows (e0 e1 s0 s1 r0 r1 g0 g1
    b0 b1; each row pair holds ids 0-127 | 128-255), on the CPU."""
    n = len(np.asarray(emission))
    e = np.zeros(256, np.float32)
    s = np.zeros(256, np.float32)
    c = np.zeros((256, 3), np.float32)
    e[:n] = np.asarray(emission, np.float32)[:256]
    s[:n] = np.asarray(scatter, np.float32)[:256]
    c[: len(np.asarray(color))] = np.asarray(color, np.float32)[:256]
    rows = np.stack([e, s, c[:, 0], c[:, 1], c[:, 2]]).reshape(10, 128)
    return torch.from_numpy(rows)


def unpack_rgba8(img):
    """Packed RGBA8 words [H,W] (int32 tensor or uint32 array) ->
    uint8[H,W,3] on the host."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    a = np.asarray(img).view(np.uint32)
    return np.stack(
        [(a & 0xFF), (a >> 8) & 0xFF, (a >> 16) & 0xFF], axis=-1
    ).astype(np.uint8)
