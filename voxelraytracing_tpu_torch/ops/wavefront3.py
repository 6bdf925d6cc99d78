"""Subwindow bit-plane world (v3 tables), the frame layout and the v3
round-serviced march.

Port of ``voxelraytracing_tpu/ops/wavefront3.py``: the host builders and
frame helpers, and the v3 frame — one service round of the march
(:func:`march3`, the CUDA kernel ``csrc/march3.cu``, plain version
:func:`march3_ref`), the host service and round loop
(:func:`_trace_frame`) and its entry points :func:`trace_wavefront3`,
:func:`trace_wavefront3_rays`, :func:`empty_frame_cache` and
:func:`render_frame3`. The world is a stack of bit planes at three
levels: per-window meta (64³ voxels), per-subwindow meta and voxel rows
(16³ voxels = 4096 bits = one 128-word row), and a global plane of
jumpable windows. A ray classifies each step from its position alone;
the self-serving v4 march lives in ``wavefront4.py``.

Bit words are carried as ``torch.int32`` with the bits of the JAX
package's ``uint32`` words: torch's uint32 has no shifts, compares or
gathers. Convert at the boundary with ``.numpy().view(np.uint32)``.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core import native
from ..core.constants import CHUNK_SIZE
from .camera import sqrt_rn
from .wavefront import (
    BRICK,
    EPS_T,
    TILE_H,
    TILE_W,
    _BIG,
    _BIG_IV,
    WavefrontResult,
    _brick_tables_np,
    _cdiv,
    _i32,
    render_id_maps,
)

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
    brick_dir/bricks: the v1 content tables (ops/wavefront.py:
      ``build_render_grid_host``): ``int32[(16·Nw)³]`` brick row of each
      4³ brick (-1: none) and ``[B·512, 16]`` words of four render ids.
      Only the ``"gather"`` hit-id route of the v3 trace reads them;
      streamed grids carry JAX's one-row stand-ins.
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
    brick_dir: torch.Tensor
    bricks: torch.Tensor
    world_min: torch.Tensor
    to_pack: torch.Tensor
    n_liquid: int
    size_voxels: int
    palettes_ok: bool


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
    # land in each row's id-0 column, which is dropped (id 0 = air). The
    # native row histogram when the library builds (as in the JAX
    # builder), else its twin: one flat bincount with int64 keys.
    ids = np.where(solid_rows, vr, 0)
    if native.available():
        cnt = native.hist256_u8(ids.astype(np.uint8))
    else:
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
    brick_dir, bricks = _brick_tables_np(grids, cells, w, to_render, vpad)
    return RenderGrid3(
        *[_i32(p, device) for p in planes],
        brick_dir=_i32(brick_dir, device),
        bricks=_i32(bricks, device),
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
# The flags word the JAX package reads from an all-zero state plane (0.0f's
# bits less its 0x30000000 f32 bias): what a camera-ray block with no ray
# active passes through. The port keeps flags as plain int32 and starts
# camera-ray planes from this word.
_FL_ZERO = -0x30000000


def _inv_dir(c):
    c2 = torch.where(c >= 0.0, torch.clamp_min(c, 1e-7),
                     torch.clamp_max(c, -1e-7))
    return 1.0 / c2


def _slab_exit(v, ox, oy, oz, iv):
    """Where a ray leaves the world's slab ``[0, v)³``, capped at
    ``4v + 16``; ``iv`` are its inverse directions (:func:`_inv_dir`)."""

    def slab(oc, ivc):
        return torch.maximum((0.0 - oc) * ivc, (v - oc) * ivc)

    t_cap = float(np.float32(4.0) * np.float32(v) + np.float32(16.0))
    return torch.clamp_max(
        torch.minimum(slab(ox, iv[0]),
                      torch.minimum(slab(oy, iv[1]), slab(oz, iv[2]))),
        t_cap)


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


def _tile_valid(tx, ty, T, device):
    """bool[T, 128] on ``device`` (the caller's tensors'): tiles that carry
    real pixels (edge superblocks pad)."""
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


# ----------------------------------------------------------- the v3 march
#
# Port of the round-serviced march (wavefront3.py:_march_kernel :483,
# launched by _march :1044, and the host round loop _trace_frame
# :1164-1745). Unlike the v4 march the kernel does not serve itself: each
# launch marches a 64-tile program (8,192 rays) only through the windows
# and subwindows that the host put into that program's cache block
# ``mc``, and returns the rays' state and a per-tile want-list; the host
# serves those wants into the next launch's block. Where a frame does
# not converge inside its round budget, which rays finish depends on that
# service, so the port keeps it word for word.

N_WC = 8      # windows cached per program (metas pack into one row)
N_SC = 16     # subwindows cached per program
_W_INS = 2    # window cache inserts per round
_S_INS = 8    # subwindow cache inserts per round
_H_REC = 16   # service rounds recorded in the frame cache token
_BIGI = 0x3FFFFFFF
_CLS = 1 << 28  # backfill priority-class stride (ids stay below it)
MC_ROWS = 5 + 6 * N_SC  # gj, gl, window metas, subwindow metas, ids, cache
_BIG_IV99 = float(np.float32(0.99 * _BIG_IV))
_TAIL_START = 5         # rounds before the tail budget
_TAIL_SUB_ROUNDS = 30   # sub-rounds a launch in the tail


def _bits(flat, idx, sh):
    """Bit ``sh`` (0-31) of the int32 words ``flat[idx]``, as int32."""
    return (flat[idx] >> sh) & 1


def _axis3(pc, ivc, sgn, cell, icell):
    """Distance to the next cell plane along one axis (wavefront3.py
    :751-766): ``floor+1`` for a positive direction, ``ceil-1`` for a
    negative one, so a position on a plane still moves off it."""
    q = pc * icell
    b = torch.where(sgn, torch.floor(q) + 1.0, torch.ceil(q) - 1.0)
    dt = (b * cell - pc) * ivc
    return torch.where(ivc.abs() >= _BIG_IV99, _BIG, dt)


def march3_ref(scal, mc, ts, fl, wa, we, rays=None, tile_map=None, *, nw,
               ns, nsx, sub_rounds, lookahead=1, sub_steps=8):
    """Plain PyTorch version of one launch of the v3 march.

    ``scal`` f32[27]: the ``_cam_scal`` row with 22 = sub-round budget
    (``sub_rounds`` when 0), 23 = step cap (none when 0), 24 = round-0
    init of camera rays, 25-26 = tile counts. ``mc`` i32[nB,101,128]: per
    program the rows gj, gl, window metas (slot k at lanes 8k..8k+7),
    subwindow metas (slot k at lanes 8k..), ids (window slots at lanes
    0-7, subwindow slots at 8-23, -1 = empty), then 16 solid, 16 liquid
    and 64 palette-index rows (slot k, bit b at row 37 + 4k + b). The
    state ``ts``/``wa``/``we`` f32[T,128] and ``fl`` i32[T,128] (flags as
    plain int32: 0 active, 1 hit, 2-4 exit axes, 5-16 steps, 17-24 id).
    ``rays`` f32[6,T,128] (origins, directions): per-ray bundles, else
    camera rays of superblock-major tiles (``tile_map`` i32[T,8]: column 0
    is the frame tile of each row of a compacted grid).

    Each program: marches in sub-rounds of ``sub_steps`` steps while the
    budget lasts and some ray of the program can progress; within a
    sub-round a ray of a tile steps only inside the one cached subwindow
    the tile picked (the smallest id a stalled ray of it needs). A program
    with no active ray passes its state through. Returns ``(ts, fl, wa,
    we), want``; ``want`` i32[T,8]: columns 0-3 the smallest uncached
    subwindow a ray of each 32-lane group stalls on, 4 the smallest
    uncached window of the tile, 5-7 the tile's prefetch ids found
    ``lookahead`` cells ahead (-1: none).

    The arithmetic is the JAX kernel's, ray by ray; only rays that can
    still move are computed: a ray that did not move in a step of a
    sub-round cannot move later in it (its position, and so its
    classification, stays), so it leaves that sub-round's working set."""
    dev = ts.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    sf = [float(x) for x in scal.detach().cpu().numpy().astype(np.float32)]
    T = ts.shape[0]
    nB = T // _BLK
    N = T * 128
    gs = _gs_for(nw)
    v = sf[3]
    cap = int(sf[23]) if sf[23] > 0.5 else 1_000_000_000
    srd = int(sf[22]) if sf[22] > 0.5 else int(sub_rounds)

    ray = torch.arange(N, dtype=i64, device=dev)
    lane = (ray % 128).to(i32)
    tile = ray // 128
    if rays is not None:
        ox, oy, oz, dx, dy, dz = (r.reshape(N) for r in rays)
    else:
        ox, oy, oz = (torch.full((N,), sf[i], dtype=f32, device=dev)
                      for i in range(3))
        tg = (tile_map[:, 0] if tile_map is not None
              else torch.arange(T, dtype=i32, device=dev))
        tg = tg.repeat_interleave(128)
        dx, dy, dz = _ray_dirs(sf, tg, lane, nsx)
    iv = [_inv_dir(dx), _inv_dir(dy), _inv_dir(dz)]
    R = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, ivx=iv[0],
             ivy=iv[1], ivz=iv[2], sx=dx > 0.0, sy=dy > 0.0, sz=dz > 0.0,
             t_exit=_slab_exit(v, ox, oy, oz, iv), tile=tile,
             base=(tile // _BLK) * (MC_ROWS * 128))
    mcf = mc.reshape(nB, MC_ROWS, 128)
    flat = mcf.reshape(-1)
    wid = mcf[:, 4, 0:N_WC]
    sid = mcf[:, 4, N_WC:N_WC + N_SC]

    # the start state: round-0 init of camera rays from the scalar row, else
    # the carried planes
    fl_in = fl.reshape(N)
    t, water, wenter = ts.reshape(N), wa.reshape(N), we.reshape(N)
    act = (fl_in & 1) != 0
    hit = ((fl_in >> 1) & 1) != 0
    axm, stp, vox = (fl_in >> 2) & 7, (fl_in >> 5) & 0xFFF, (fl_in >> 17) & 0xFF
    if rays is None and sf[24] > 0.5:
        txi, tyi = _tile_xy(tg, nsx)
        act = (txi.to(f32) < sf[25]) & (tyi.to(f32) < sf[26])
        if not (0.0 < sf[0] < v and 0.0 < sf[1] < v and 0.0 < sf[2] < v):
            act = torch.zeros_like(act)
        t = torch.full((N,), EPS_T, dtype=f32, device=dev)
        water = torch.zeros((N,), dtype=f32, device=dev)
        wenter = torch.full((N,), -1.0, dtype=f32, device=dev)
        hit = torch.zeros((N,), dtype=torch.bool, device=dev)
        axm, stp, vox = (torch.zeros((N,), dtype=i32, device=dev)
                         for _ in range(3))
    any_active = act.reshape(nB, -1).any(dim=1)
    pos = [R["ox"] + R["dx"] * t, R["oy"] + R["dy"] * t, R["oz"] + R["dz"] * t]
    inw0 = torch.ones_like(act)
    for p in pos:
        inw0 = inw0 & (p >= 0.0) & (p < v)
    act = act & (stp < cap) & inw0 & (t < R["t_exit"])
    S = dict(t=t.clone(), act=act, hit=hit, axm=axm, vox=vox,
             water=water.clone(), wenter=wenter.clone(), stp=stp)

    def cls(Q, tt, need_sslot=True):
        return _classify3(Q, tt, flat, wid, sid, nw, ns, gs, need_sslot)

    def boundary():
        """Each tile's subwindow (the smallest cached id a stalled ray
        needs), its cache slot, and whether any ray of each program can
        progress."""
        c = cls(R, S["t"])
        need = S["act"] & ~c["g_jump"] & (c["wslot"] >= 0) & ~c["sw_jump"]
        skey = torch.where(need & (c["sslot"] >= 0), c["s"], _BIGI)
        smin = skey.reshape(T, 128).amin(dim=1)
        tsid = torch.where(smin < _BIGI, smin, -1)
        slot = _slot_of(tsid, sid.repeat_interleave(_BLK, dim=0))
        tslot, match = slot.clamp_min(0), slot >= 0
        can = S["act"] & (c["g_jump"] | ((c["wslot"] >= 0) & c["sw_jump"])
                          | (need & (c["s"] == tsid[tile])))
        return tsid, tslot, match, can.reshape(nB, -1).any(dim=1)

    def cached_bit(Q, r0, l):
        """Bit ``l`` of the tile's composed row (cache row ``r0`` + its
        slot; zeros where the tile's subwindow is not cached)."""
        b = _bits(flat, Q["base"] + r0 * 128 + (Q["tslot"] * 128
                                                + (l >> 5)).long(), l & 31)
        return torch.where(Q["match"], b, 0)

    def step(Q):
        """One step of the rays of ``Q`` (all active at entry); returns
        whether each moved (marched or hit)."""
        t = Q["t"]
        c = cls(Q, t, need_sslot=False)
        active = t < Q["t_exit"]
        for p in (c["px"], c["py"], c["pz"]):
            active = active & (p >= 0.0) & (p < v)
        active = active & (Q["stp"] < cap)
        vx, vy, vz = c["vx"], c["vy"], c["vz"]
        b_loc = ((vx >> 2) & 3) + ((vy >> 2) & 3) * 4 + ((vz >> 2) & 3) * 16
        bbase = (Q["tslot"] * 8 + (b_loc >> 5)).clamp(0, 127).long()
        sm = Q["base"] + 3 * 128
        br_jump = _bits(flat, sm + bbase, b_loc & 31) != 0
        br_liq = _bits(flat, sm + (bbase + 2).clamp(0, 127), b_loc & 31) != 0
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        vsolid = cached_bit(Q, 5, l) != 0
        vliq = cached_bit(Q, 5 + N_SC, l) != 0
        g_jump, wslot, sw_jump = c["g_jump"], c["wslot"], c["sw_jump"]
        case1 = active & g_jump
        case2 = active & ~g_jump & (wslot >= 0) & sw_jump
        case3 = (active & ~g_jump & (wslot >= 0) & ~sw_jump
                 & (c["s"] == Q["tsid"]))
        in_br = case3 & br_jump
        in_vox = case3 & ~br_jump
        hit_now = in_vox & vsolid
        march = case1 | case2 | in_br | (in_vox & ~vsolid)
        liquid = torch.where(case1, c["g_liq"], torch.where(
            case2, c["sw_liq"], torch.where(in_br, br_liq, vliq)))
        wen = Q["wenter"]
        leave = (march | hit_now) & (wen >= 0.0) & ~liquid
        Q["water"] = Q["water"] + torch.where(leave, t - wen, 0.0)
        wen = torch.where(leave, -1.0, wen)
        Q["wenter"] = torch.where(march & liquid & (wen < 0.0), t, wen)
        cell = torch.where(case1, float(WIN << gs), torch.where(
            case2, float(SW), torch.where(in_br, float(BRICK), 1.0)))
        icell = 1.0 / cell
        dtx = _axis3(c["px"], Q["ivx"], Q["sx"], cell, icell)
        dty = _axis3(c["py"], Q["ivy"], Q["sy"], cell, icell)
        dtz = _axis3(c["pz"], Q["ivz"], Q["sz"], cell, icell)
        dt = torch.minimum(dtx, torch.minimum(dty, dtz))
        axm_now = ((dtx <= dt).to(i32) | ((dty <= dt).to(i32) << 1)
                   | ((dtz <= dt).to(i32) << 2))
        Q["t"] = torch.where(march, t + dt + EPS_T, t)
        Q["axm"] = torch.where(march, axm_now, Q["axm"])
        Q["hit"] = Q["hit"] | hit_now
        Q["act"] = active & ~hit_now
        moved = march | hit_now
        Q["stp"] = Q["stp"] + moved.to(i32)
        return moved

    def decode_hits(Q):
        """Pack ids of undecoded hits, from the composed palette-index rows
        and the palette words of the tile's subwindow meta."""
        t = Q["t"]
        vx = torch.floor(Q["ox"] + Q["dx"] * t).to(i32)
        vy = torch.floor(Q["oy"] + Q["dy"] * t).to(i32)
        vz = torch.floor(Q["oz"] + Q["dz"] * t).to(i32)
        l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256
        pidx = torch.zeros_like(l)
        slot4 = dict(Q, tslot=Q["tslot"] * 4)
        for b in range(4):
            pidx = pidx | (cached_bit(slot4, 5 + 2 * N_SC + b, l) << b)
        widx = (Q["tslot"] * 8 + 4 + (pidx >> 2)).clamp(0, 127).long()
        pal_w = flat[Q["base"] + 3 * 128 + widx]
        return (pal_w >> ((pidx & 3) * 8)) & 0xFF

    state_keys = ("t", "act", "hit", "axm", "vox", "water", "wenter", "stp")
    tsid, tslot, match, go = boundary()
    run = any_active & go & (0 < srd)
    sr = 0
    while bool(run.any()):
        on = run.repeat_interleave(_BLK * 128)
        row = dict(tsid=tsid[tile], tslot=tslot[tile], match=match[tile])
        idx = torch.nonzero(on & S["act"]).squeeze(1)
        for _ in range(sub_steps):
            if not idx.numel():
                break
            Q = {k: x[idx] for k, x in R.items()}
            Q.update({k: x[idx] for k, x in row.items()})
            Q.update({k: S[k][idx] for k in state_keys})
            moved = step(Q)
            for k in state_keys:
                S[k][idx] = Q[k]
            idx = idx[moved & Q["act"]]
        und = torch.nonzero(on & S["hit"] & (S["vox"] == 0)).squeeze(1)
        if und.numel():
            Q = {k: x[und] for k, x in R.items()}
            Q.update({k: x[und] for k, x in row.items()})
            Q["t"] = S["t"][und]
            S["vox"][und] = decode_hits(Q)
        S["t"] = torch.where(on, torch.minimum(S["t"], R["t_exit"]), S["t"])
        S["act"] = S["act"] & ~(on & (S["stp"] >= cap))
        n_tsid, n_tslot, n_match, go = boundary()
        rt = run.repeat_interleave(_BLK)
        tsid = torch.where(rt, n_tsid, tsid)
        tslot = torch.where(rt, n_tslot, tslot)
        match = torch.where(rt, n_match, match)
        sr += 1
        run = run & go & (sr < srd)

    sgn = R["sx"].to(i32) | (R["sy"].to(i32) << 1) | (R["sz"].to(i32) << 2)
    fl_out = (S["act"].to(i32) | (S["hit"].to(i32) << 1) | (S["axm"] << 2)
              | (torch.clamp_max(S["stp"], 0xFFF) << 5) | (S["vox"] << 17)
              | (sgn << 25))
    want = _wants(cls, R, S["t"], S["act"], gs, lookahead).reshape(T, 8)
    on = any_active.repeat_interleave(_BLK * 128)
    out = (torch.where(on, S["t"], ts.reshape(N)),
           torch.where(on, fl_out, fl_in),
           torch.where(on, S["water"], wa.reshape(N)),
           torch.where(on, S["wenter"], we.reshape(N)))
    want = torch.where(any_active.repeat_interleave(_BLK)[:, None], want, -1)
    return tuple(x.reshape(T, 128) for x in out), want


def _slot_of(x, ids):
    """The cache slot holding ``x`` (the last of equal ones, as the JAX
    kernel's compare chain leaves it), -1 where none: ``ids`` [..., k],
    broadcast against ``x[..., None]``."""
    k = torch.arange(ids.shape[-1], dtype=torch.int32, device=x.device)
    eq = (x[..., None] == ids) & (ids >= 0)
    return torch.where(eq, k, -1).amax(dim=-1)


def _classify3(Q, t, flat, wid, sid, nw, ns, gs, need_sslot=True):
    """Everything a v3 step derives from a ray's position (wavefront3.py
    :594-641): voxel, window and subwindow ids, the global-plane bits,
    the cached window slot and its subwindow bits, the cached subwindow
    slot. ``Q`` holds the rays (origins, directions and the flat offset
    ``base`` of their program's ``mc`` block)."""
    i32 = torch.int32
    nwg = (nw + (1 << gs) - 1) >> gs
    px = Q["ox"] + Q["dx"] * t
    py = Q["oy"] + Q["dy"] * t
    pz = Q["oz"] + Q["dz"] * t
    vx = torch.floor(px).to(i32)
    vy = torch.floor(py).to(i32)
    vz = torch.floor(pz).to(i32)
    w = (vx >> 6) + (vy >> 6) * nw + (vz >> 6) * (nw * nw)
    if gs:
        wg = ((vx >> (6 + gs)) + (vy >> (6 + gs)) * nwg
              + (vz >> (6 + gs)) * (nwg * nwg))
    else:
        wg = w
    base = Q["base"]
    gw = (wg >> 5).clamp(0, 127).long()
    g_jump = _bits(flat, base + gw, wg & 31) != 0
    g_liq = _bits(flat, base + 128 + gw, wg & 31) != 0
    prog = base // (MC_ROWS * 128)
    wslot = _slot_of(w, wid[prog])
    s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16
    mbase = torch.clamp_min(wslot, 0) * 8 + (s_loc >> 5)
    wm = base + 2 * 128
    sw_jump = _bits(flat, wm + mbase.clamp(0, 127).long(), s_loc & 31) != 0
    sw_liq = _bits(flat, wm + (mbase + 2).clamp(0, 127).long(),
                   s_loc & 31) != 0
    s = (vx >> 4) + (vy >> 4) * ns + (vz >> 4) * (ns * ns)
    sslot = None
    if need_sslot:
        sslot = _slot_of(s, sid[prog])
    return dict(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, w=w, g_jump=g_jump,
                g_liq=g_liq, wslot=wslot, sw_jump=sw_jump, sw_liq=sw_liq,
                s=s, sslot=sslot)


def _wants(cls, R, t, active, gs, lookahead):
    """The want-list of each tile (wavefront3.py:787-882), [T,8]: walk
    each stalled ray ``lookahead`` cells ahead, crossing uncached
    subwindows optimistically, and collect the first uncached subwindows
    on its way (its immediate stall, then up to three prefetch ids) and
    the first uncached window, where the walk stops."""
    T = t.shape[0] // 128
    tw = t
    alive = active
    wwid = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)
    ch = [wwid.clone() for _ in range(4)]
    for j in range(lookahead):
        c = cls(R, tw)
        alive = alive & (tw < R["t_exit"])
        wun = alive & ~c["g_jump"] & (c["wslot"] < 0)
        wwid = torch.where((wwid < 0) & wun, c["w"], wwid)
        alive = alive & ~wun
        s = c["s"]
        new = alive & ~c["g_jump"] & ~c["sw_jump"] & (c["sslot"] < 0)
        for cj in ch:
            new = new & (s != cj)
        if j == 0:
            ch[0] = torch.where(new, s, ch[0])
        else:
            prev = None
            for k in range(1, 4):
                e = new & (ch[k] < 0)
                if prev is not None:
                    e = e & ~prev
                    prev = prev | e
                else:
                    prev = e
                ch[k] = torch.where(e, s, ch[k])
        if j + 1 < lookahead:
            cell = torch.where(c["g_jump"], float(WIN << gs), float(SW))
            icell = 1.0 / cell
            dt = torch.minimum(
                _axis3(c["px"], R["ivx"], R["sx"], cell, icell),
                torch.minimum(_axis3(c["py"], R["ivy"], R["sy"], cell, icell),
                              _axis3(c["pz"], R["ivz"], R["sz"], cell, icell)))
            tw = torch.where(alive, tw + dt + EPS_T, tw)

    def tile_min(x, groups):
        k = torch.where(x >= 0, x, _BIGI).reshape(T, groups, -1).amin(dim=2)
        return torch.where(k < _BIGI, k, -1)

    cols = [tile_min(ch[0], 4), tile_min(wwid, 1)]
    if lookahead <= 1:
        cols.append(torch.full((T, 3), -1, dtype=torch.int32,
                               device=t.device))
    else:
        cols += [tile_min(c, 1) for c in ch[1:]]
    return torch.cat(cols, dim=1)


def march3(scal, mc, ts, fl, wa, we, rays=None, tile_map=None, *, nw, ns,
           nsx, sub_rounds, lookahead=1, sub_steps=8):
    """One launch of the v3 march -> ``(ts, fl, wa, we), want``.

    On CUDA tensors: one launch of the hand-written kernel
    ``csrc/march3.cu`` (built at first use), a cluster of two 1,024-thread
    blocks a 64-tile program; on CPU tensors: the plain version
    :func:`march3_ref`.
    Any other device raises. Same arguments as :func:`march3_ref`."""
    from .wavefront4 import _check, _device_of, _run

    dev = _device_of(ts, "march3")
    if dev.type == "cpu":
        return march3_ref(scal, mc, ts, fl, wa, we, rays, tile_map, nw=nw,
                          ns=ns, nsx=nsx, sub_rounds=sub_rounds,
                          lookahead=lookahead, sub_steps=sub_steps)
    T = ts.shape[0]
    if T % _BLK:
        raise ValueError(f"{T} tiles is not a whole number of programs")
    f32, i32 = torch.float32, torch.int32
    checks = [("scal", scal, f32, (_SCAL_N,)),
              ("mc", mc, i32, (T // _BLK, MC_ROWS, 128)),
              ("ts", ts, f32, (T, 128)), ("fl", fl, i32, (T, 128)),
              ("wa", wa, f32, (T, 128)), ("we", we, f32, (T, 128))]
    if rays is not None:
        checks.append(("rays", rays, f32, (6, T, 128)))
    if tile_map is not None:
        checks.append(("tile_map", tile_map, i32, (T, 8)))
    _check(dev, checks)
    out = [torch.empty_like(ts), torch.empty_like(fl), torch.empty_like(wa),
           torch.empty_like(we)]
    want = torch.empty((T, 8), dtype=i32, device=dev)
    _run(dev, "march3", _build.load("march3").march3_launch,
         scal.data_ptr(), mc.data_ptr(),
         None if rays is None else rays.data_ptr(),
         None if tile_map is None else tile_map.data_ptr(),
         ts.data_ptr(), fl.data_ptr(), wa.data_ptr(), we.data_ptr(),
         *(x.data_ptr() for x in out), want.data_ptr(),
         T, nw, ns, nsx, int(sub_rounds), int(sub_steps), int(lookahead))
    march3.launches += 1
    return tuple(out), want


march3.launches = 0  # kernel launches since the last reset


# ------------------------------------------------- the service and the frame


def _sw_cont3(rg):
    """The per-frame service table [Ns³,7,128]: rows solid | liquid | 4
    palette-index planes | the 8 subwindow meta words padded to a row
    (wavefront3.py:1246-1256; not the interleaved v4 table)."""
    meta = torch.nn.functional.pad(rg.sw_meta, (0, 128 - rg.sw_meta.shape[1]))
    return torch.cat([rg.sw_solid[:, None], rg.sw_liq[:, None], rg.sw_pid,
                      meta[:, None]], dim=1)


def _in_any(x, ids):
    """``x[b, i]`` equals one of ``ids[b, :]``."""
    return (x[:, :, None] == ids[:, None, :]).any(dim=2)


def _insert_windows(c, r, wmeta):
    """Serve up to two distinct uncached window wants per program
    (wavefront3.py:1346-1368) into slots 1-7 in turn; slot 0 keeps the
    camera's window. Returns the new ids and meta row."""
    nb = c["wc_ids"].shape[0]
    lane = torch.arange(128, device=wmeta.device)
    pool = c["want"][:, 4].reshape(nb, _BLK)
    pool = torch.where((pool >= 0) & ~_in_any(pool, c["wc_ids"]), pool, _BIGI)
    wc_ids, wc_meta = c["wc_ids"].clone(), c["wc_meta"]
    for j in range(_W_INS):
        pick = pool.amin(dim=1)
        ok = pick < _BIGI
        pool = torch.where(pool == pick[:, None], _BIGI, pool)
        slot = (r * _W_INS + j) % (N_WC - 1) + 1
        wc_ids[:, slot] = torch.where(ok, pick, wc_ids[:, slot])
        meta = wmeta[torch.clamp(pick, 0, wmeta.shape[0] - 1).long()]
        spread = meta[:, lane & 7]
        sel = ((lane >> 3) == slot)[None, :] & ok[:, None]
        wc_meta = torch.where(sel, spread, wc_meta)
    return wc_ids, wc_meta


def _insert_subwindows(c, r, hist_x, sw_cont):
    """Serve up to eight subwindow wants per program (wavefront3.py
    :1370-1482): the smallest uncached immediate want of each eighth of
    the program (8 tiles), a repeated pick kept only at its first eighth;
    empty picks filled, in the order of a running count, from one pool
    of the leftover immediate wants, then the ids this round served in
    the previous frame (``hist_x``), then the prefetch wants, the class
    in bits 28+ of the key. Even rounds replace slots 0-7, odd rounds
    8-15; a slot with no pick keeps its row. Returns the new ids, meta
    row, solid, liquid and palette rows, and the served ids."""
    nb = c["sc_ids"].shape[0]
    dev = sw_cont.device
    lane = torch.arange(128, device=dev)
    pool = c["want"][:, :4].reshape(nb, _BLK * 4)
    pool = torch.where((pool >= 0) & ~_in_any(pool, c["sc_ids"]), pool, _BIGI)
    picks = pool.reshape(nb, _S_INS, -1).amin(dim=2)
    dup = (picks[:, :, None] == picks[:, None, :]).to(torch.int32)
    first = torch.argmax(dup, dim=2)            # first equal pick
    picks = torch.where(first == torch.arange(_S_INS, device=dev), picks,
                        _BIGI)
    pool = torch.where(_in_any(pool, picks), _BIGI, pool)
    hrow = hist_x[min(max(r, 0), _H_REC - 1)]
    prepool = c["want"][:, 5:8].reshape(nb, _BLK * 3)

    def mask(p, bias):
        ok = (p >= 0) & ~_in_any(p, c["sc_ids"]) & ~_in_any(p, picks)
        return torch.where(ok, p + bias, _BIGI)

    cpool = torch.cat([pool, mask(hrow, _CLS), mask(prepool, 2 * _CLS)], 1)
    idm = _CLS - 1
    fill = []
    for _ in range(_S_INS):
        g = cpool.amin(dim=1)
        fill.append(torch.where(g < _BIGI, g & idm, _BIGI))
        cpool = torch.where((cpool & idm) == (g[:, None] & idm), _BIGI, cpool)
    fill = torch.stack(fill, dim=1)
    need = picks >= _BIGI
    order = torch.cumsum(need.to(torch.int32), dim=1) - 1
    picks = torch.where(need, torch.gather(
        fill, 1, torch.clamp(order, 0, _S_INS - 1)), picks)
    ok = picks < _BIGI
    new_ids = torch.where(ok, picks, -1)
    cont = sw_cont[torch.clamp(picks, 0, sw_cont.shape[0] - 1).long()]

    half = slice(0, _S_INS) if r % 2 == 0 else slice(_S_INS, N_SC)

    def put(old, new, okx):
        out = old.clone()
        out[:, half] = torch.where(okx, new, old[:, half])
        return out

    sc_ids = put(c["sc_ids"], new_ids, ok)
    sc_solid = put(c["sc_solid"], cont[:, :, 0], ok[..., None])
    sc_liq = put(c["sc_liq"], cont[:, :, 1], ok[..., None])
    sc_pid = put(c["sc_pid"], cont[:, :, 2:6], ok[..., None, None])
    meta64 = cont[:, :, 6, :8].reshape(nb, _S_INS * 8)
    spread = meta64[:, lane & (_S_INS * 8 - 1)]
    ok_ln = ok[:, (lane >> 3) & (_S_INS - 1)]
    lo = r % 2 == 0
    sel = (lo == (lane < _S_INS * 8))[None, :] & ok_ln
    sc_meta = torch.where(sel, spread, c["sc_meta"])
    return sc_ids, sc_meta, sc_solid, sc_liq, sc_pid, new_ids


def _last_rows(idx):
    """Positions of ``idx`` (int64, host) that no later position repeats:
    a scatter through them writes what a sequential scatter would leave."""
    idx = idx.tolist()
    return [i for i, x in enumerate(idx) if x not in idx[i + 1:]]


def _cache_args(cache):
    """``(wc_ids, sc_ids, hist)`` of a frame-cache token, ``hist`` None for
    the legacy 2-tuple; None for no token (wavefront3.py:1815-1830)."""
    if cache is None:
        return None
    if len(cache) == 2:
        return cache[0], cache[1], None
    return tuple(cache)


def empty_frame_cache(width, height, device="cuda"):
    """An all-empty service-cache token for a ``width`` x ``height`` frame:
    ``(wc_ids i32[nB,8], sc_ids i32[nB,16], hist i32[16,nB,8])`` of -1
    on ``device``. As ``cache=`` it gives the cold start through the warm
    path."""
    _, _, T = _sb_dims(width // TILE_W, height // TILE_H)
    nb = T // _BLK
    full = dict(dtype=torch.int32, device=device)
    return (torch.full((nb, N_WC), -1, **full),
            torch.full((nb, N_SC), -1, **full),
            torch.full((_H_REC, nb, _S_INS), -1, **full))


def _trace_frame(rg, origin, inv_view, inv_proj, rays=None, active0=None,
                 cache=None, rounds=16, step_cap=None, *, width, height,
                 sub_rounds, resolve_ids="palette", raw_out=False,
                 return_cache=False, lookahead=1, compact=True,
                 full_height=None, y0=0.0):
    """The v3 round loop of one frame (wavefront3.py:_trace_frame).

    Camera rays from ``origin`` (world-local) and the camera matrices, or
    the per-ray bundle ``rays`` f32[6,T,128] in the superblock-major tile
    layout with ``active0`` bool[T,128]. ``cache``: a token from a
    previous frame (see :func:`trace_wavefront3`) warm-starts every
    program's cache ids and the service's history. Each round serves the
    last launch's wants into every program's cache block and launches
    :func:`march3` once; round 0 always runs, then rounds run while a ray
    is active, up to ``rounds``. ``compact`` (True = one quarter-size
    level, False, or a tuple of grid divisors) moves the surviving tiles
    into smaller grids once they fit, with twice the round budget there.

    ``raw_out=True``: the tiled planes ``(ts, fl, wa, we)`` [T,128]; else
    a :class:`WavefrontResult` in image order. ``return_cache`` adds the
    token ``(wc_ids, sc_ids, hist)``. ``full_height``/``y0``: camera rays
    of the horizontal band of rows ``y0 .. y0 + height`` of a
    ``full_height``-row frame (bundles ignore them)."""
    f32, i32 = torch.float32, torch.int32
    sub_steps = 8
    dev = rg.sw_solid.device
    tx, ty = width // TILE_W, height // TILE_H
    nsx, _, T = _sb_dims(tx, ty)
    nb = T // _BLK
    n_sw = rg.sw_solid.shape[0]
    if n_sw >= _CLS:
        raise ValueError("subwindow ids must stay below the class stride")
    ns = int(round(n_sw ** (1 / 3)))
    while ns * ns * ns < n_sw:
        ns += 1
    nw = ns // 4
    v = int(rg.size_voxels)
    scal = _cam_scal(origin, inv_view, inv_proj, v, width,
                     height if full_height is None else full_height, y0)
    sw_cont = _sw_cont3(rg)
    wmeta = rg.wmeta
    valid = _tile_valid(tx, ty, T, dev)
    per_ray = rays is not None

    shape = (T, 128)
    if per_ray:
        o = rays[:3]
        inside = ((o > 0.0) & (o < v)).all(dim=0) & active0
        state = (torch.full(shape, EPS_T, dtype=f32, device=dev),
                 (inside & valid).to(i32),
                 torch.zeros(shape, dtype=f32, device=dev),
                 torch.full(shape, -1.0, dtype=f32, device=dev))
        seed_o = rays[:3, 0, 0].cpu().numpy()
    else:
        # camera rays start from zero planes; the kernel inits them on
        # round 0 (an untouched program keeps them)
        state = (torch.zeros(shape, dtype=f32, device=dev),
                 torch.full(shape, _FL_ZERO, dtype=i32, device=dev),
                 torch.zeros(shape, dtype=f32, device=dev),
                 torch.zeros(shape, dtype=f32, device=dev))
        seed_o = np.asarray(origin, np.float32)

    full = dict(dtype=i32, device=dev)
    cam_w = np.clip(np.floor(np.asarray(seed_o, np.float32) / np.float32(WIN))
                    .astype(np.int64), 0, nw - 1)
    cam_wid = int(cam_w[0] + cam_w[1] * nw + cam_w[2] * nw * nw)
    carry = dict(
        state=state,
        wc_ids=torch.full((nb, N_WC), -1, **full),
        sc_ids=torch.full((nb, N_SC), -1, **full),
        want=torch.full((T, 8), -1, **full),
        hist=torch.full((_H_REC, nb, _S_INS), -1, **full),
        wc_meta=torch.zeros((nb, 128), **full),
        sc_meta=torch.zeros((nb, 128), **full),
        sc_solid=torch.zeros((nb, N_SC, 128), **full),
        sc_liq=torch.zeros((nb, N_SC, 128), **full),
        sc_pid=torch.zeros((nb, N_SC, 4, 128), **full),
    )
    hist_in = torch.full((_H_REC, nb, _S_INS), -1, **full)
    # every program's window slot 0 holds the camera's window
    carry["wc_ids"][:, 0] = cam_wid
    carry["wc_meta"][:, :8] = wmeta[cam_wid]
    tok = _cache_args(cache)
    if tok is not None:
        # warm start: the previous frame's cache ids, their rows re-read
        # from the current tables (wavefront3.py:1305-1333)
        wc0 = torch.as_tensor(tok[0], device=dev).to(i32).clone()
        wc0[:, 0] = cam_wid
        okw = wc0 >= 0
        wmall = torch.where(okw[..., None], wmeta[torch.clamp(
            wc0, 0, wmeta.shape[0] - 1).long()], 0)
        carry["wc_ids"] = torch.where(okw, wc0, -1)
        carry["wc_meta"] = torch.nn.functional.pad(
            wmall.reshape(nb, 8 * N_WC), (0, 128 - 8 * N_WC))
        sc0 = torch.as_tensor(tok[1], device=dev).to(i32)
        oks = sc0 >= 0
        carry["sc_ids"] = torch.where(oks, sc0, -1)
        conts = torch.where(oks[..., None, None], sw_cont[torch.clamp(
            sc0, 0, n_sw - 1).long()], 0)
        carry["sc_meta"] = conts[:, :, 6, :8].reshape(nb, 128)
        carry["sc_solid"] = conts[:, :, 0]
        carry["sc_liq"] = conts[:, :, 1]
        carry["sc_pid"] = conts[:, :, 2:6]
        if tok[2] is not None and torch.as_tensor(tok[2]).ndim == 3:
            hist_in = torch.as_tensor(tok[2], device=dev).to(i32)

    if step_cap is None:
        cap = min(np.float32(rounds) * np.float32(sub_rounds * sub_steps),
                  np.float32(4000.0))
    else:
        cap = min(np.float32(step_cap), np.float32(4000.0))
    rows = {}

    def scal_for(r):
        srd = (sub_rounds if r < _TAIL_START
               else max(_TAIL_SUB_ROUNDS, sub_rounds))
        init = not per_ray and r == 0
        key = (srd, init)
        if key not in rows:
            row = scal.copy()
            row[22], row[23] = srd, cap
            if not per_ray:
                row[24], row[25], row[26] = float(init), tx, ty
            rows[key] = torch.from_numpy(row).to(dev)
        return rows[key]

    gj = rg.gw_jump.reshape(1, 128)
    gl = rg.gw_liq.reshape(1, 128)

    def round_body(c, r, hist_x, rays_x, tmap_x):
        nbx = c["wc_ids"].shape[0]
        wc_ids, wc_meta = _insert_windows(c, r, wmeta)
        sc_ids, sc_meta, sc_solid, sc_liq, sc_pid, served = \
            _insert_subwindows(c, r, hist_x, sw_cont)
        hist = c["hist"].clone()
        hist[min(max(r, 0), _H_REC - 1)] = served
        ids = torch.cat([wc_ids, sc_ids, torch.full(
            (nbx, 128 - N_WC - N_SC), -1, **full)], dim=1)
        mc = torch.cat([
            torch.stack([gj.expand(nbx, 128), gl.expand(nbx, 128), wc_meta,
                         sc_meta, ids], dim=1),
            sc_solid, sc_liq, sc_pid.reshape(nbx, N_SC * 4, 128)],
            dim=1).contiguous()
        st, want = march3(scal_for(r), mc, *c["state"], rays_x, tmap_x,
                          nw=nw, ns=ns, nsx=nsx, sub_rounds=sub_rounds,
                          lookahead=lookahead, sub_steps=sub_steps)
        return dict(state=st, want=want, hist=hist, wc_ids=wc_ids,
                    wc_meta=wc_meta, sc_ids=sc_ids, sc_meta=sc_meta,
                    sc_solid=sc_solid, sc_liq=sc_liq, sc_pid=sc_pid)

    divisors = (4,) if compact is True else (tuple(compact) if compact else ())
    sizes = []
    for d in divisors:
        tk = max(_BLK, -(-(T // int(d)) // _BLK) * _BLK)
        if tk < (sizes[-1] if sizes else T):
            sizes.append(tk)

    def act_tiles(c):
        return ((c["state"][1] & 1) != 0).any(dim=1)

    def run_level(cy, r, hist_x, rays_x, tmap_x, orig_ids, level):
        nxt = sizes[level] if level < len(sizes) else None
        r_cap = rounds if level == 0 else 2 * rounds
        while r < r_cap:
            act_t = act_tiles(cy)
            more = bool(act_t.any() if nxt is None else act_t.sum() > nxt)
            if not (more or (level == 0 and r == 0)):
                break
            cy = round_body(cy, r, hist_x, rays_x, tmap_x)
            r += 1
        if nxt is None:
            return cy
        act_t = act_tiles(cy)
        if not bool(act_t.any()):
            return cy
        # stable partition: tiles with an active ray first, in order
        perm = torch.sort((~act_t).to(torch.int8), stable=True).indices
        selt = perm[:nxt]
        src = selt.reshape(nxt // _BLK, _BLK)[:, 0] // _BLK
        orig_n = selt if orig_ids is None else orig_ids[selt]
        hist_b = cy["hist"][:, src]
        c_b = dict(state=tuple(p[selt] for p in cy["state"]),
                   want=cy["want"][selt], hist=hist_b)
        for k in ("wc_ids", "wc_meta", "sc_ids", "sc_meta", "sc_solid",
                  "sc_liq", "sc_pid"):
            c_b[k] = cy[k][src]
        c_b = run_level(
            c_b, r, hist_b, None if rays is None else rays[:, orig_n],
            orig_n[:, None].expand(nxt, 8).to(i32).contiguous(), orig_n,
            level + 1)
        out = dict(cy)
        out["state"] = tuple(p.index_copy(0, selt, q)
                             for p, q in zip(cy["state"], c_b["state"]))
        # learned ids and schedule flow back to the seed programs (the
        # last compacted program of a seed wins, as in a sequential scatter)
        keep = torch.tensor(_last_rows(src.cpu()), dtype=torch.int64,
                            device=dev)
        dst = src[keep]
        for k in ("wc_ids", "sc_ids"):
            out[k] = cy[k].index_copy(0, dst, c_b[k][keep])
        out["hist"] = cy["hist"].index_copy(1, dst, c_b["hist"][:, keep])
        return out

    carry = run_level(carry, 0, hist_in, rays, None, None, 0)

    ts, fl, wa, we = carry["state"]
    cache_out = (carry["wc_ids"], carry["sc_ids"], carry["hist"])
    if raw_out:
        return ((ts, fl, wa, we), cache_out) if return_cache else (ts, fl,
                                                                    wa, we)
    res = _finish3(rg, ts, fl, wa, we, scal, rays, resolve_ids, tx, ty,
                   width, height)
    return (res, cache_out) if return_cache else res


def _finish3(rg, ts, fl, wa, we, scal, rays, resolve_ids, tx, ty, width,
             height):
    """The :class:`WavefrontResult` of a v3 frame (wavefront3.py
    :1660-1744): a ray that used up its budget without a hit is a miss;
    the water interval closes at the carried ``t``; hit ids come from the
    in-kernel palette decode (``"palette"``), the v1 brick tables
    (``"gather"``) or are the hit mask (``"none"``)."""
    from .wavefront import WavefrontResult

    f32, i32 = torch.float32, torch.int32
    hit = ((fl >> _FL_HIT) & 1) != 0
    axmask = (fl >> _FL_AX) & 7
    sgnb = (fl >> _FL_SGN) & 7
    water = wa + torch.where(we >= 0.0, ts - we, 0.0)
    if resolve_ids == "palette":
        voxel = torch.where(hit, (fl >> _FL_VOX) & 0xFF, 0)
    elif resolve_ids == "gather":
        T = ts.shape[0]
        if rays is not None:
            o, (dx, dy, dz) = rays[:3], rays[3:]
        else:
            o = torch.tensor(scal[:3], device=ts.device).view(3, 1, 1)
            nsx = _sb_dims(tx, ty)[0]
            tile = torch.arange(T, dtype=i32, device=ts.device)[:, None]
            lane = torch.arange(128, dtype=i32, device=ts.device)[None, :]
            dx, dy, dz = _ray_dirs(scal, tile.expand(T, 128),
                                   lane.expand(T, 128), nsx)
        bg_side = _cdiv(int(rg.size_voxels), WIN) * 16  # bricks an edge
        hi = bg_side * BRICK - 1
        h = [torch.clamp(torch.floor(oc + d * ts).to(i32), 0, hi)
             for oc, d in zip(o, (dx, dy, dz))]
        fb = (h[0] >> 2) + (h[1] >> 2) * bg_side + (h[2] >> 2) * (bg_side * bg_side)
        brow = rg.brick_dir[fb.long()]
        vlin = (h[0] & 3) + (h[1] & 3) * 4 + (h[2] & 3) * 16
        wd = rg.bricks[torch.clamp(brow, 0, rg.bricks.shape[0] - 1).long(),
                       (vlin >> 2).long()]
        rid = (wd >> ((vlin & 3) * 8)) & 0xFF
        rid = torch.where(hit & (brow >= 0), rid, 0)
        voxel = rg.to_pack[rid.long()]
    elif resolve_ids == "none":
        voxel = hit.to(i32)
    else:
        raise ValueError(f"unknown resolve_ids {resolve_ids!r}")
    norm = [-(2.0 * ((sgnb >> b) & 1).to(f32) - 1.0) * ((axmask >> b) & 1).to(f32)
            for b in range(3)]
    steps = (fl >> _FL_STP) & 0xFFF

    def untile(x):
        return _untile_hw(x, tx, ty, width, height)

    return WavefrontResult(
        hit=untile(hit), voxel=untile(voxel),
        norm=torch.stack([untile(n) for n in norm], dim=-1),
        t=untile(ts), water_dist=untile(water), steps=untile(steps))



def _host_f32(x):
    """A host float32 array of ``x`` (a tensor on any device, or array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _tile_bundle(origins, dirs, active, width, height, device):
    """Image-order bundles f32[H,W,3] / bool[H,W] -> the tiled ray planes
    f32[6,T,128] and activity bool[T,128] of the v3 march."""
    tx, ty = width // TILE_W, height // TILE_H
    T = _sb_dims(tx, ty)[2]

    def tiled(x):
        x = torch.as_tensor(x, device=device).to(torch.float32)
        x = x.expand(height, width, 3)
        return _tile_hw(x, tx, ty, T).permute(2, 0, 1)

    act = torch.as_tensor(active, device=device).expand(height, width)
    act = _tile_hw(act.to(torch.uint8), tx, ty, T) != 0
    return torch.cat([tiled(origins), tiled(dirs)]).contiguous(), act


def _require_tiles(width, height):
    if width % TILE_W or height % TILE_H:
        raise ValueError(
            f"{width}x{height}: width must be a multiple of {TILE_W} and "
            f"height of {TILE_H}")


def trace_wavefront3(rg: RenderGrid3, origin, dirs=None, *, cam=None,
                     width=None, height=None, rounds=16, steps_per_round=48,
                     interpret=None, resolve_ids=None, cache=None,
                     return_cache=False, lookahead=1, step_cap=None,
                     compact=True):
    """March one frame of camera rays through the v3 round loop ->
    :class:`WavefrontResult` ([H, W] planes on the grid's device).

    The signature of the JAX ``trace_wavefront3``: ``origin`` is the
    world-local camera position, ``cam`` the CamData (``dirs`` is
    accepted and ignored: the march derives directions from ``cam``).
    ``rounds`` service rounds of ``steps_per_round // 8`` sub-rounds of 8
    steps each; the step cap is ``min(rounds * steps_per_round, 4000)``
    or ``step_cap``. A ray still active when the rounds run out is a miss.
    ``cache``: the token ``(wc_ids, sc_ids, hist)`` of a previous frame's
    ``return_cache=True`` call (or JAX's legacy 2-tuple, or
    :func:`empty_frame_cache`): it steers the service, so it changes which
    rays finish within a budget. ``resolve_ids``: ``"palette"`` (default
    for ``palettes_ok`` grids), ``"gather"`` (the default otherwise) or
    ``"none"``. ``interpret`` is a TPU switch and is ignored."""
    del dirs, interpret
    if cam is None:
        raise ValueError("trace_wavefront3 needs cam=CamData")
    if width is None or height is None:
        width, height = cam.proj_size
    _require_tiles(width, height)
    if resolve_ids is None:
        resolve_ids = "palette" if rg.palettes_ok else "gather"
    return _trace_frame(
        rg, _host_f32(origin), cam.inv_view, cam.inv_proj, cache=cache,
        rounds=rounds, step_cap=step_cap, width=width, height=height,
        sub_rounds=max(steps_per_round // 8, 1), resolve_ids=resolve_ids,
        return_cache=return_cache, lookahead=int(lookahead),
        compact=compact)


def trace_wavefront3_rays(rg: RenderGrid3, origins, dirs, active, *, width,
                          height, rounds=16, steps_per_round=48,
                          interpret=None, resolve_ids=None, cache=None,
                          return_cache=False, compact=True):
    """March per-ray (origin, direction) bundles through the v3 round loop
    -> :class:`WavefrontResult`.

    The signature of the JAX ``trace_wavefront3_rays``: ``origins`` and
    ``dirs`` f32[H,W,3] world-local, ``active`` bool[H,W], always read in
    image order (JAX reads a bundle of shape [T,128,3] as already tiled,
    ROADMAP queue 3). A ray marches if it is active, its tile is whole and
    its origin lies strictly inside the world. Other keywords as in
    :func:`trace_wavefront3`."""
    del interpret
    _require_tiles(width, height)
    if resolve_ids is None:
        resolve_ids = "palette" if rg.palettes_ok else "gather"
    rays, act = _tile_bundle(origins, dirs, active, width, height,
                             rg.sw_solid.device)
    eye = np.eye(4, dtype=np.float32)
    return _trace_frame(
        rg, np.zeros(3, np.float32), eye, eye, rays, act, cache=cache,
        rounds=rounds, width=width, height=height,
        sub_rounds=max(steps_per_round // 8, 1), resolve_ids=resolve_ids,
        return_cache=return_cache, compact=compact)


def _render_frame(rg, origin, cam, lut, row, *, rounds, sub_rounds,
                  step_cap, shadows, show_steps, cache_p, cache_s, compact,
                  y0=0.0, band_height=None):
    """Primary trace, optional hard-shadow trace and shade of one v3 frame
    (wavefront3.py:_render_frame :2079). ``row`` is the host f32[43] row
    of :func:`_frame_row3`. With ``band_height``, the band of rows ``y0 ..
    y0 + band_height`` of the camera's frame (``row`` made for that band).
    Returns the packed RGBA8 and flags images [H, W] (H the band's height)
    and the token pair."""
    from .wavefront4 import _shadow_rays, _split_shade_row, shade4

    width, full_height = cam.proj_size
    height = full_height if band_height is None else band_height
    tx, ty = width // TILE_W, height // TILE_H
    nsx, _, T = _sb_dims(tx, ty)
    dev = rg.sw_solid.device
    kw = dict(width=width, height=height, sub_rounds=sub_rounds,
              step_cap=step_cap, raw_out=True, return_cache=True,
              compact=compact)
    (ts, fl, wa, we), tok_p = _trace_frame(
        rg, origin, cam.inv_view, cam.inv_proj, cache=cache_p,
        rounds=rounds, full_height=full_height, y0=y0, **kw)
    sh = torch.zeros_like(fl)
    tok_s = tok_p
    if shadows:
        sf = [float(x) for x in row]
        tile = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
        lane = torch.arange(128, dtype=torch.int32, device=dev)[None, :]
        d = _ray_dirs(sf, tile.expand(T, 128), lane.expand(T, 128), nsx)
        srays = torch.stack(_shadow_rays(sf, *d, ts, (fl >> _FL_AX) & 7))
        hitm = ((fl >> _FL_HIT) & 1) != 0
        eye = np.eye(4, dtype=np.float32)
        (_, fls, _, _), tok_s = _trace_frame(
            rg, np.zeros(3, np.float32), eye, eye, srays, hitm,
            cache=cache_s, rounds=max(rounds // 2, 4), **kw)
        sh = (fls >> _FL_HIT) & 1

    def untile(x):
        return _untile_hw(x, tx, ty, width, height).contiguous()

    srow = torch.from_numpy(_split_shade_row(row)).to(dev)
    img = shade4(srow, lut, untile(ts), untile(fl), untile(wa), untile(we),
                 untile(sh), show_steps=show_steps, shadows=shadows,
                 max_steps=rounds * sub_rounds * 8)
    return img, untile(fl), (tok_p, tok_s)


def _frame_row3(rg, cam, materials_color, *, world_min=None, sky_color,
                sun_pos, sun_intensity, shadow_ambient, y0=0.0):
    """``(origin, lut, row)`` of a v3 frame: the world-local camera, the
    colour LUT [6, 128] on the grid's device and the host f32[43] row of
    :func:`~.wavefront4._shade_params` (``_cam_scal`` of the camera's full
    frame, with the band offset ``y0``)."""
    from .wavefront4 import _shade_params

    width, height = cam.proj_size
    wm = _host_f32(rg.world_min if world_min is None else world_min)
    origin = np.asarray(cam.pos, np.float32) - wm
    sun_local = np.asarray(sun_pos, np.float32) - wm
    if getattr(materials_color, "shape", None) == (6, 128):
        lut = torch.as_tensor(materials_color)
    else:
        lut = color_lut_rows(materials_color)
    lut = lut.to(device=rg.sw_solid.device, dtype=torch.float32).contiguous()
    row = _shade_params(
        _cam_scal(origin, cam.inv_view, cam.inv_proj, int(rg.size_voxels),
                  width, height, y0),
        origin, sun_local, sky_color=sky_color, sun_intensity=sun_intensity,
        shadow_ambient=shadow_ambient)
    return origin, lut, row


def render_frame3(rg: RenderGrid3, cam, materials_color, *, world_min=None,
                  sky_color=(0.81, 0.93, 1.0), sun_pos=(0.0, 10_000.0, 0.0),
                  sun_intensity=4.0, shadows=False, shadow_ambient=0.4,
                  show_steps=False, rounds=16, steps_per_round=48,
                  step_cap=None, interpret=None, with_flags=False, cache=None,
                  return_cache=False, compact=True):
    """One shaded frame through the v3 round loop -> packed RGBA8
    ``i32[H,W]`` on the grid's device.

    The signature of the JAX ``render_frame3``: the camera rays march
    ``rounds`` service rounds; with ``shadows`` each hit re-marches toward
    the sun as a per-ray bundle at ``max(rounds // 2, 4)`` rounds; the
    split shade (:func:`~.wavefront4.shade4`) scales the step heatmap to
    ``rounds * (steps_per_round // 8) * 8``. ``with_flags`` adds the
    flags image. ``cache``/``return_cache``: the (primary, shadow) token
    pair of :func:`trace_wavefront3` (without shadows the shadow token is
    the primary one). ``materials_color``: [n,3] colours or a
    :func:`color_lut_rows` result. ``interpret`` is ignored."""
    from .wavefront4 import _log

    del interpret
    if not rg.palettes_ok:
        _log.warning(
            "rendering with overflowed subwindow palettes: a few voxels in "
            ">16-solid-id regions take the most-frequent entry's color")
    origin, lut, row = _frame_row3(
        rg, cam, materials_color, world_min=world_min, sky_color=sky_color,
        sun_pos=sun_pos, sun_intensity=sun_intensity,
        shadow_ambient=shadow_ambient)
    cache_p = cache_s = None
    if cache is not None:
        cache_p, cache_s = cache
    img, fl, tok = _render_frame(
        rg, origin, cam, lut, row, rounds=int(rounds),
        sub_rounds=max(steps_per_round // 8, 1),
        step_cap=None if step_cap is None else int(step_cap),
        shadows=bool(shadows), show_steps=bool(show_steps),
        cache_p=cache_p, cache_s=cache_s, compact=compact)
    ret = (img, fl) if with_flags else (img,)
    if return_cache:
        ret = ret + (tok,)
    return ret if len(ret) > 1 else ret[0]
